"""The JAX package's random initialisation, in numpy.

A neural provider persisted with only a seed (``describe()`` with no
checkpoint) names its weights by ``init_*_params(jax.random.PRNGKey(seed))``.
To rebuild that identity with the same weights without JAX, this module
reproduces the three calls those initialisers make, as JAX 0.9 runs them with
its defaults (the ``threefry2x32`` generator, ``jax_threefry_partitionable``
on):

- :func:`prng_key` — ``jax.random.PRNGKey(seed)``: the key ``(0, seed &
  0xFFFFFFFF)`` as two uint32 words (without x64 JAX keeps a seed's low 32
  bits);
- :func:`split` — ``jax.random.split(key, num)``: the Threefry-2x32 hash of
  the 64-bit counters ``0 .. num-1`` (high word, low word) under the key; each
  output pair is a new key;
- :func:`fold_in` — ``jax.random.fold_in(key, data)``: the hash of the
  counter pair ``(0, data)`` under the key;
- :func:`normal` — ``jax.random.normal(key, shape, float32)``: 32 random bits
  per element (the hash of its flat index, both output words xor-ed), a
  uniform in [nextafter(-1, 0), 1) made from the top 23 bits, then
  ``sqrt(2) · erfinv(u)`` with XLA's float32 ``erf_inv`` polynomial
  (M. Giles, "Approximating the erfinv function"), evaluated step by step in
  float32 as XLA lowers it.

Keys and bits are bit-equal to ``jax.random``'s. The normals agree to float32
rounding: XLA's ``log1p`` inside ``erf_inv`` is its own approximation, so a
draw may differ from JAX's in its last bits (the tests hold them to rtol 1e-5).

:func:`init_encoder_params`, :func:`init_splade_params` and
:func:`init_cross_encoder_params` are the JAX package's initialisers on top
of these (same key order, same layout: layers
stacked on a leading axis), returning numpy trees that
`models.highlighter.params_from_jax` loads into the port's modules.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .config import EncoderConfig

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds: the hash of the counter pairs
    ``(x0, x1)`` (uint32 arrays of one shape) under ``key`` (two uint32).
    Sums wrap modulo 2^32 (numpy array arithmetic)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    a = np.asarray(x0, np.uint32) + ks[0]
    b = np.asarray(x1, np.uint32) + ks[1]
    tmp = np.empty_like(b)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a += b
            np.left_shift(b, np.uint32(r), out=tmp)
            b >>= np.uint32(32 - r)
            b |= tmp
            b ^= a
        a += ks[(i + 1) % 3]
        with np.errstate(over="ignore"):  # uint32 scalar sums wrap, as the arrays' do
            b += ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def _counters(shape) -> tuple[np.ndarray, np.ndarray]:
    """The 64-bit iota over ``shape`` as (high words, low words)."""
    n = int(np.prod(shape, dtype=np.int64))
    iota = np.arange(n, dtype=np.uint64)
    hi = (iota >> np.uint64(32)).astype(np.uint32).reshape(shape)
    lo = (iota & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)
    return hi, lo


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as a uint32 array [2]: ``(0, seed mod
    2^32)``, as JAX without x64 (the JAX package's setting) makes it from any
    integer seed, wider ones included."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: uint32 keys [num, 2]."""
    hi, lo = _counters((num,))
    a, b = threefry2x32(key, hi, lo)
    return np.stack([a, b], axis=1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: a uint32 key [2]."""
    a, b = threefry2x32(key, np.zeros(1, np.uint32), np.array([data & 0xFFFFFFFF], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def random_bits(key, shape) -> np.ndarray:
    """32 random bits per element, uint32 of ``shape``."""
    hi, lo = _counters(tuple(shape))
    a, b = threefry2x32(key, hi, lo)
    return a ^ b


#: XLA's float32 erf_inv coefficients (w < 5, then w ≥ 5), highest degree first.
_ERFINV_LT5 = np.array(
    [2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
     -0.00125372503, -0.00417768164, 0.246640727, 1.50140941],
    np.float32,
)
_ERFINV_GE5 = np.array(
    [-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
     -0.0076224613, 0.00943887047, 1.00167406, 2.83297682],
    np.float32,
)


def erf_inv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv``: ``w = -log1p(-x²)``, a degree-8 polynomial
    in ``w − 2.5`` (w < 5) or ``√w − 3``, times x; ±1 → ±inf."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        w = -np.log1p(x * -x)
        lt = w < np.float32(5.0)
        w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
        p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(np.float32)
        for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            p = np.where(lt, lo, hi).astype(np.float32) + p * w
        out = p * x
        return np.where(np.abs(x) == np.float32(1.0), x * np.float32(np.inf), out).astype(np.float32)


def uniform(key, shape, minval: float, maxval: float) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erf_inv_f32(u)).astype(np.float32)


# -- the JAX package's initialisers ---------------------------------------------------


def _dense_init(key, d_in, d_out, use_bias, scale=0.02) -> dict[str, np.ndarray]:
    p = {"kernel": normal(key, (d_in, d_out)) * np.float32(scale)}
    if use_bias:
        p["bias"] = np.zeros((d_out,), np.float32)
    return p


def _ln_init(dim, use_bias=True) -> dict[str, np.ndarray]:
    p = {"scale": np.ones((dim,), np.float32)}
    if use_bias:
        p["bias"] = np.zeros((dim,), np.float32)
    return p


def init_encoder_params(key, config: EncoderConfig) -> dict[str, Any]:
    """JAX `models/encoder.py::init_encoder_params` in numpy: the same tree
    (layers stacked on a leading axis) from the same key."""
    keys = split(key, 8)
    h = config.hidden_size
    inter = config.intermediate_size
    wi_out = 2 * inter if config.activation == "geglu" else inter
    ln_bias = config.use_bias or config.norm_location == "post"

    embeddings: dict[str, Any] = {"word": normal(keys[0], (config.vocab_size, h)) * np.float32(0.02)}
    if config.position_embedding_type == "absolute":
        embeddings["position"] = normal(keys[1], (config.max_position_embeddings, h)) * np.float32(0.02)
    if config.type_vocab_size:
        embeddings["token_type"] = normal(keys[2], (config.type_vocab_size, h)) * np.float32(0.02)
    if config.embedding_norm:
        embeddings["ln"] = _ln_init(h, ln_bias)

    def layer_params(k):
        ks = split(k, 6)
        return {
            "attn": {name: _dense_init(ks[i], h, h, config.use_bias) for i, name in enumerate("qkvo")},
            "attn_ln": _ln_init(h, ln_bias),
            "mlp": {
                "wi": _dense_init(ks[4], h, wi_out, config.use_bias),
                "wo": _dense_init(ks[5], inter, h, config.use_bias),
            },
            "mlp_ln": _ln_init(h, ln_bias),
        }

    per_layer = [layer_params(k) for k in split(keys[3], config.num_layers)]

    def stack(*trees):
        if isinstance(trees[0], dict):
            return {name: stack(*(t[name] for t in trees)) for name in trees[0]}
        return np.stack(trees)

    params: dict[str, Any] = {"embeddings": embeddings, "layers": stack(*per_layer)}
    if config.final_norm:
        params["final_ln"] = _ln_init(h, config.use_bias)
    return params


def init_splade_params(key, config: EncoderConfig) -> dict[str, Any]:
    """JAX `models/splade.py::init_splade_params` in numpy: the encoder from
    the first half of ``split(key)``, the MLM transform from the second."""
    k_enc, k_head = split(key)
    params = init_encoder_params(k_enc, config)
    h = config.hidden_size
    params["mlm_head"] = {
        "transform": {
            "kernel": normal(k_head, (h, h)) * np.float32(0.02),
            "bias": np.zeros((h,), np.float32),
        },
        "ln": {"scale": np.ones((h,), np.float32), "bias": np.zeros((h,), np.float32)},
        "output_bias": np.zeros((config.vocab_size,), np.float32),
    }
    return params


def init_cross_encoder_params(key, config: EncoderConfig) -> dict[str, Any]:
    """JAX `models/reranker.py::init_cross_encoder_params` in numpy: the
    encoder from the first half of ``split(key)``; the pooler from the second,
    the score head from that key folded with 1."""
    k_enc, k_head = split(key)
    params = init_encoder_params(k_enc, config)
    h = config.hidden_size
    params["pooler"] = {
        "kernel": normal(k_head, (h, h)) * np.float32(0.02),
        "bias": np.zeros((h,), np.float32),
    }
    params["score"] = {
        "kernel": normal(fold_in(k_head, 1), (h, 1)) * np.float32(0.02),
        "bias": np.zeros((1,), np.float32),
    }
    return params
