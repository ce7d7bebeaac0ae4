"""Sequence-parallel attention in the PyTorch port vs the JAX package.

The JAX side runs on its 8 virtual CPU devices (``make_mesh(dp=1, tp=8)``),
the port on a mesh of 8 repeated ``"cpu"`` devices; inputs come from one
numpy seed. Tolerances (float32 throughout): the partial function's m and l
rtol 1e-5, atol 1e-6 and its numerator rtol 1e-4, atol 1e-5 (the JAX
package's own kernel-vs-block test); dead rows exactly (-1e30, 0, 0);
ring and halo outputs rtol/atol 2e-4 (the JAX package's ring tests).
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from verbatim_rag_tpu.ops.flash_attention import flash_attention_partial as jax_partial
from verbatim_rag_tpu.ops.ring_attention import (
    _block_attend,
    halo_attention as jax_halo,
    ring_attention as jax_ring,
    shard_sequence as jax_shard,
)
from verbatim_rag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from verbatim_rag_tpu_torch.ops import flash_attention as fa
from verbatim_rag_tpu_torch.ops.ring_attention import (
    halo_attention,
    ring_attention,
    shard_sequence,
)
from verbatim_rag_tpu_torch.parallel import Mesh, make_mesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(dp=1, tp=8), make_mesh(dp=1, tp=8, devices=["cpu"] * 8)


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


# -- the partial function -------------------------------------------------------------

#: (k_offset, lengths): blocks fully live, partly live, past one row's length
#: and past every row's (all rows dead); row 2 is empty throughout.
PARTIAL_CASES = {
    "first_block": (0, [70, 55, 0]),
    "straddles_length": (24, [70, 55, 0]),
    "past_one_length": (60, [70, 55, 0]),
    "all_dead": (100, [70, 55, 0]),
}


@pytest.mark.parametrize("case", sorted(PARTIAL_CASES))
def test_partial_matches_jax_kernel_and_block_attend(case):
    k_offset, lengths = PARTIAL_CASES[case]
    q, k, v = _arrays([(3, 32, 2, 16), (3, 48, 2, 16), (3, 48, 2, 16)], seed=k_offset)
    lens = np.asarray(lengths, np.int32)
    interp = jax_partial(*map(jnp.asarray, (q, k, v, lens)), jnp.int32(k_offset), interpret=True)
    block = _block_attend(*map(jnp.asarray, (q, k, v)), k_offset, jnp.asarray(lens), seq_len=10**6)
    before = fa.partial_launches
    got = fa.flash_attention_partial(*map(torch.from_numpy, (q, k, v, lens)), k_offset)
    assert fa.partial_launches == before  # CPU tensors take the plain version
    for expected in (interp, block):
        for name, g, e, tol in zip(
            ("numer", "m", "l"), got, expected, ((1e-4, 1e-5), (1e-5, 1e-6), (1e-5, 1e-6))
        ):
            assert g.dtype == torch.float32 and g.shape == e.shape, name
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=tol[0], atol=tol[1], err_msg=name)
    numer, m, l = got
    dead = k_offset >= lens  # rows with no live key in this block
    assert dead[2]
    assert (m[dead] == fa.NEG_INF).all() and (l[dead] == 0).all() and (numer[dead] == 0).all()
    assert (l[~dead] > 0).all()


@pytest.mark.parametrize("case", sorted(PARTIAL_CASES))
def test_partial_at_head_dim_32_matches_jax_kernel(case):
    """MiniLM's head dim (the ring step of a MiniLM-width highlighter run or
    trained sequence-parallel): the plain partial against JAX's partial
    kernel in interpret mode and its block attention, at the tolerances
    above; dead rows exactly (-1e30, 0, 0)."""
    k_offset, lengths = PARTIAL_CASES[case]
    q, k, v = _arrays([(3, 32, 2, 32), (3, 48, 2, 32), (3, 48, 2, 32)], seed=k_offset + 32)
    lens = np.asarray(lengths, np.int32)
    interp = jax_partial(*map(jnp.asarray, (q, k, v, lens)), jnp.int32(k_offset), interpret=True)
    block = _block_attend(*map(jnp.asarray, (q, k, v)), k_offset, jnp.asarray(lens), seq_len=10**6)
    got = fa.flash_attention_partial(*map(torch.from_numpy, (q, k, v, lens)), k_offset)
    for expected in (interp, block):
        for name, g, e, tol in zip(
            ("numer", "m", "l"), got, expected, ((1e-4, 1e-5), (1e-5, 1e-6), (1e-5, 1e-6))
        ):
            assert g.shape == e.shape == ((3, 32, 2, 32) if name == "numer" else (3, 2, 32)), name
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=tol[0], atol=tol[1], err_msg=name)
    numer, m, l = got
    dead = k_offset >= lens
    assert (m[dead] == fa.NEG_INF).all() and (l[dead] == 0).all() and (numer[dead] == 0).all()


def test_partial_bf16_inputs_match_jax_block_attend():
    """bf16 q, k, v: both sides multiply the (exact) bf16 values in float32."""
    q, k, v = _arrays([(2, 24, 2, 16), (2, 40, 2, 16), (2, 40, 2, 16)], seed=5)
    lens = np.asarray([50, 31], np.int32)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    expected = _block_attend(jq, jk, jv, 16, jnp.asarray(lens), seq_len=10**6)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = fa.flash_attention_partial(tq, tk, tv, torch.from_numpy(lens), 16)
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g.numpy(), np.asarray(e, np.float32), rtol=1e-4, atol=1e-5)


def test_partial_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 8, 1, 64)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fa.flash_attention_partial_cuda(q, q, q, torch.ones(1, dtype=torch.int32), 0)


def test_partial_on_cpu_is_differentiable():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _arrays([(1, 8, 1, 16)] * 3, seed=2))
    numer, _, l = fa.flash_attention_partial(q, k, v, torch.tensor([6], dtype=torch.int32), 0)
    (numer.sum() + l.sum()).backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all() for x in (q, k, v))


# -- the mesh and sharding -------------------------------------------------------------


def test_make_mesh_shape_and_errors():
    mesh = make_mesh(dp=2, tp=4, devices=["cpu"] * 8)
    assert isinstance(mesh, Mesh) and mesh.axis_names == ("dp", "tp")
    assert mesh.shape == {"dp": 2, "tp": 4}
    assert mesh.axis_devices("tp") == [torch.device("cpu")] * 4
    assert len(mesh.axis_devices("dp")) == 2
    assert make_mesh(tp=2, devices=["cpu"] * 8).shape == {"dp": 4, "tp": 2}
    with pytest.raises(ValueError) as port_err:
        make_mesh(dp=3, tp=2, devices=["cpu"] * 8)
    with pytest.raises(ValueError) as jax_err:
        jax_make_mesh(dp=3, tp=2)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.axis_devices("sp")


def test_make_mesh_without_devices_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(dp=1, tp=1)


def test_shard_sequence_chunks_dim_1(meshes):
    _, mesh = meshes
    x = torch.arange(2 * 64 * 3).reshape(2, 64, 3)
    shards = shard_sequence(x, mesh)
    assert len(shards) == 8 and all(s.shape == (2, 8, 3) and s.is_contiguous() for s in shards)
    assert torch.equal(torch.cat(shards, dim=1), x)
    with pytest.raises(ValueError, match="divide evenly"):
        shard_sequence(torch.zeros(1, 60), mesh)


# -- ring and halo attention ----------------------------------------------------------


def _sharded(meshes, arrays):
    jax_mesh, mesh = meshes
    jax_side = [jax_shard(jnp.asarray(x), jax_mesh) for x in arrays]
    port_side = [shard_sequence(torch.from_numpy(x), mesh) for x in arrays]
    return jax_side, port_side


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("lengths", [[64, 47], [64, 0], [9, 33]])
def test_ring_matches_jax(meshes, use_flash, lengths):
    """Every query row, padded ones included (they attend to the live keys in
    both packages); a zero-length row is 0 in both."""
    jax_mesh, mesh = meshes
    arrays = _arrays([(2, 64, 2, 16)] * 3, seed=sum(lengths))
    (jq, jk, jv), (tq, tk, tv) = _sharded(meshes, arrays)
    lens = np.asarray(lengths, np.int32)
    expected = np.asarray(jax_ring(jq, jk, jv, jnp.asarray(lens), jax_mesh, use_flash=use_flash))
    got = ring_attention(tq, tk, tv, torch.from_numpy(lens), mesh)
    assert len(got) == 8 and all(g.shape == (2, 8, 2, 16) for g in got)
    np.testing.assert_allclose(torch.cat(got, dim=1).numpy(), expected, rtol=2e-4, atol=2e-4)


def test_ring_matches_single_device_attention(meshes):
    _, mesh = meshes
    q, k, v = (torch.from_numpy(x) for x in _arrays([(2, 64, 2, 16)] * 3, seed=3))
    lens = torch.tensor([64, 45], dtype=torch.int32)
    expected = fa.attention_reference(q, k, v, lens)
    got = torch.cat(
        ring_attention(*(shard_sequence(x, mesh) for x in (q, k, v)), lens, mesh), dim=1
    )
    torch.testing.assert_close(got[0], expected[0], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got[1, :45], expected[1, :45], rtol=2e-4, atol=2e-4)


def test_ring_on_repeated_device_rotates_blocks(monkeypatch):
    """A ring of 4 shards on one device takes 4² partial calls and gives the
    same result as the mesh of distinct (virtual) devices would."""
    mesh = make_mesh(dp=1, tp=4, devices=["cpu"] * 4)
    q, k, v = (torch.from_numpy(x) for x in _arrays([(1, 32, 1, 16)] * 3, seed=8))
    lens = torch.tensor([27], dtype=torch.int32)
    calls = []
    original = fa.flash_attention_partial_reference

    def spy(q_, k_, v_, lengths_, k_offset):
        calls.append(k_offset)
        return original(q_, k_, v_, lengths_, k_offset)

    monkeypatch.setattr(fa, "flash_attention_partial_reference", spy)
    got = ring_attention(*(shard_sequence(x, mesh) for x in (q, k, v)), lens, mesh)
    # Step i: shard my holds block (my − i) mod 4, at offset 8·block.
    assert calls == [8 * ((my - i) % 4) for i in range(4) for my in range(4)]
    torch.testing.assert_close(
        torch.cat(got, dim=1)[0, :27], fa.attention_reference(q, k, v, lens)[0, :27],
        rtol=2e-4, atol=2e-4,
    )


@pytest.mark.parametrize("window", [16, 6])
def test_halo_matches_jax(meshes, window):
    jax_mesh, mesh = meshes
    arrays = _arrays([(2, 64, 2, 16)] * 3, seed=window)
    (jq, jk, jv), (tq, tk, tv) = _sharded(meshes, arrays)
    lens = np.asarray([64, 50], np.int32)
    expected = np.asarray(jax_halo(jq, jk, jv, jnp.asarray(lens), window, jax_mesh))
    got = halo_attention(tq, tk, tv, torch.from_numpy(lens), window, mesh)
    np.testing.assert_allclose(torch.cat(got, dim=1).numpy(), expected, rtol=2e-4, atol=2e-4)
    single = fa.attention_reference(*map(torch.from_numpy, arrays), torch.from_numpy(lens), window)
    np.testing.assert_allclose(
        torch.cat(got, dim=1)[1, :50].numpy(), single[1, :50].numpy(), rtol=2e-4, atol=2e-4
    )


def test_halo_query_chunks_give_the_same_result(meshes, monkeypatch):
    ra = sys.modules["verbatim_rag_tpu_torch.ops.ring_attention"]
    _, mesh = meshes
    arrays = [torch.from_numpy(x) for x in _arrays([(2, 64, 2, 16)] * 3, seed=4)]
    shards = [shard_sequence(x, mesh) for x in arrays]
    lens = torch.tensor([64, 37], dtype=torch.int32)
    whole = halo_attention(*shards, lens, 16, mesh)
    monkeypatch.setattr(ra, "HALO_SCORE_BYTES", 4 * 2 * 2 * 24 * 3)  # 3 query rows a chunk
    chunked = halo_attention(*shards, lens, 16, mesh)
    for a, b in zip(chunked, whole):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_halo_oversized_window_raises_as_jax(meshes):
    jax_mesh, mesh = meshes
    (q,) = _arrays([(1, 64, 1, 8)], seed=0)
    (jq,), (tq,) = _sharded(meshes, [q])
    with pytest.raises(ValueError, match="halo_attention requires") as jax_err:
        jax_halo(jq, jq, jq, jnp.asarray([64], jnp.int32), 32, jax_mesh)
    with pytest.raises(ValueError, match="halo_attention requires") as port_err:
        halo_attention(tq, tq, tq, torch.tensor([64], dtype=torch.int32), 32, mesh)
    assert str(port_err.value) == str(jax_err.value)


def test_halo_uneven_shards_raise_as_jax(meshes):
    jax_mesh, mesh = meshes
    q = jnp.zeros((1, 60, 1, 8), jnp.float32)
    with pytest.raises(ValueError, match="divide evenly") as jax_err:
        jax_halo(q, q, q, jnp.asarray([60], jnp.int32), 8, jax_mesh)
    shards = [torch.zeros(1, 8, 1, 8)] * 7 + [torch.zeros(1, 4, 1, 8)]
    with pytest.raises(ValueError, match="divide evenly") as port_err:
        halo_attention(shards, shards, shards, torch.tensor([60], dtype=torch.int32), 8, mesh)
    assert str(port_err.value) == str(jax_err.value)
