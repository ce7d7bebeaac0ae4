"""Compare the SASS of one CUDA source of the PyTorch port between two trees.

    python3 scripts/torch_sass_diff.py --base DIR [--tree DIR] [--source section]
        [--kernels REGEX] [--instance ILi64E]

Compiles ``csrc/<source>.cu`` of each tree (``--tree`` defaults to the
checkout holding this script) with this checkout's ``cuda_build.NVCC_FLAGS``
into this checkout's ``build/sass_diff/``, disassembles both libraries with
``cuobjdump -sass`` and compares them kernel by kernel (mangled names that
match ``--kernels``, all by default). A kernel is identical when its whole
listing, instruction words included, is the same in both. For one that is
not, it counts the instructions of each and the instructions that differ
once operands are dropped (opcodes alone, by `difflib`). A kernel that is a
template in one tree and a plain function in the other is compared with its
``--instance`` (for example ``ILi64E``, the head-dim-64 instance): the two
names then differ, the listings need not. Prints one JSON line; needs
``nvcc`` and ``cuobjdump``, not a GPU.

To set a change against its parent:

    git archive <parent> | tar -x -C build/parent
    python3 scripts/torch_sass_diff.py --base build/parent --kernels wgmma_kernel
"""

from __future__ import annotations

import argparse
import difflib
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

from chip_smoke import kernel_name  # noqa: E402
from verbatim_rag_tpu_torch.ops import cuda_build  # noqa: E402

_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_ANONYMOUS = re.compile(r"_GLOBAL__N__[0-9a-f]+_")
#: The anonymous namespace of a `split_sass` name (its hash dropped, so its
#: length prefix no longer holds): ``_ZN<n>_GLOBAL__N__<file>_cu_<8 hex>``.
_NAMESPACE = re.compile(r"^_ZN\d+_GLOBAL__N__\w*?_cu_[0-9a-f]{8}")


def build(tree: Path, source: str, out: Path) -> Path:
    out.parent.mkdir(parents=True, exist_ok=True)
    source_file = tree / "verbatim_rag_tpu_torch" / "csrc" / f"{source}.cu"
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(source_file)]
    subprocess.run(cmd, check=True, capture_output=True, timeout=600)
    return out


def functions(library: Path) -> dict[str, list[str]]:
    """Mangled kernel name → its SASS listing lines (`split_sass`)."""
    tool = Path(cuda_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True, check=True, timeout=300)
    return split_sass(sass.stdout)


def split_sass(text: str) -> dict[str, list[str]]:
    """A `cuobjdump -sass` listing → {mangled kernel name: its lines}, with
    the anonymous namespace's per-file hash dropped from every name (it
    changes with the source text, so it would tell two trees' kernels
    apart)."""
    out, current = {}, None
    for line in _ANONYMOUS.sub("_GLOBAL__N__", text).splitlines():
        func = re.search(r"Function : (\S+)", line)
        if func:
            current = out.setdefault(func.group(1), [])
        elif current is not None and line.strip():
            current.append(line.strip())
    return out


def opcodes(lines: list[str]) -> list[str]:
    """The opcodes of a listing's instructions, predicates and operands dropped."""
    ops = []
    for line in lines:
        m = _INSTRUCTION.search(line)
        if m:
            text = re.sub(r"^@!?U?P\w+\s+", "", m.group(1))  # drop the predicate guard
            ops.append(text.split()[0])
    return ops


def pair_instances(base: dict, tree: dict, instance: str) -> dict[str, str]:
    """{tree name: base name} for kernels found in only one tree whose short
    names (`chip_smoke.kernel_name`) differ by ``instance`` alone: a plain
    kernel in one tree, its template's instance in the other. Either side
    may hold the template."""
    pairs = {}
    if not instance:
        return pairs

    def short(name: str) -> str:
        return kernel_name(_NAMESPACE.sub("_Z", name))

    only_base = {short(n): n for n in base if n not in tree}
    only_tree = {short(n): n for n in tree if n not in base}
    for short, name in only_tree.items():
        if short.endswith(instance) and short[: -len(instance)] in only_base:
            pairs[name] = only_base[short[: -len(instance)]]
        elif short + instance in only_base:
            pairs[name] = only_base[short + instance]
    return pairs


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base", type=Path, required=True)
    parser.add_argument("--tree", type=Path, default=HERE)
    parser.add_argument("--source", default="section")
    parser.add_argument("--kernels", default="")
    parser.add_argument("--instance", default="")
    args = parser.parse_args()

    out_dir = HERE / "build" / "sass_diff"
    base = functions(build(args.base.resolve(), args.source, out_dir / f"base-{args.source}.so"))
    tree = functions(build(args.tree.resolve(), args.source, out_dir / f"tree-{args.source}.so"))
    pattern = re.compile(args.kernels)
    pairs = pair_instances(base, tree, args.instance)
    paired = set(pairs.values())
    result = {}
    for name in sorted(set(base) | set(tree)):
        if not pattern.search(name) or (name in paired and name not in tree):
            continue
        base_name = pairs.get(name, name)
        if base_name not in base or name not in tree:
            result[name] = dict(only_in="tree" if name in tree else "base")
            continue
        a, b = opcodes(base[base_name]), opcodes(tree[name])
        changed = sum(
            max(i2 - i1, j2 - j1)
            for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes()
            if tag != "equal"
        )
        result[name] = dict(
            identical=base[base_name] == tree[name], instructions=[len(a), len(b)], opcodes_differing=changed
        )
        if base_name != name:
            result[name]["base_kernel"] = base_name
    print(json.dumps(dict(source=args.source, base=str(args.base), tree=str(args.tree), kernels=result)))


if __name__ == "__main__":
    main()
