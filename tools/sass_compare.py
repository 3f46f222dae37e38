#!/usr/bin/env python3
"""The flash kernels' SASS in this checkout against another checkout's, opcode by opcode.

Builds both checkouts' kernel libraries (as the package builds them), disassembles each
with ``cuobjdump -sass`` and, for every kernel of the other checkout, counts each opcode
in it and in this checkout's kernel of the same name: the same template arguments, or the
same followed by ``0`` (a template flag this checkout added, off). One line a kernel:
``same`` when every count is equal, else the opcodes whose counts differ.

Run from the repository root on a machine with the CUDA toolkit, e.g. against the parent
commit unpacked into ``build/parent``:

    python3 tools/sass_compare.py --root build/parent
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"


def opcode_counts(library: Path) -> dict:
    """Per kernel (``name<args>``), the count of each SASS opcode."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import kernel_name

    listing = subprocess.run([CUOBJDUMP, "-sass", str(library)], capture_output=True, text=True, check=True).stdout
    kernels, current = {}, None
    for line in listing.splitlines():
        function = re.match(r"\s+Function : (\S+)", line)
        if function:
            current = kernels.setdefault(kernel_name(function.group(1)), collections.Counter())
            continue
        instruction = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
        if instruction and current is not None:
            current[instruction.group(2).split(".")[0]] += 1
    return kernels


def built_libraries(root: Path) -> dict:
    """``{source: library path}`` of the checkout at ``root``, built first."""
    script = ("import sys; sys.path.insert(0, sys.argv[1]); from hivemind_tpu_torch.ops import _build; "
              "print('\\n'.join(f'{name} {path}' for name, path in _build.build_all().items()))")
    out = subprocess.run([sys.executable, "-c", script, str(root)], capture_output=True, text=True, check=True).stdout
    return dict(line.split(" ", 1) for line in out.strip().splitlines())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True, help="the other checkout")
    args = parser.parse_args(argv)
    ours, theirs = built_libraries(ROOT), built_libraries(Path(args.root).resolve())
    differ = 0
    for source in sorted(set(ours) & set(theirs)):
        new, old = opcode_counts(Path(ours[source])), opcode_counts(Path(theirs[source]))
        for name, counts in sorted(old.items()):
            match = next((n for n in (name, name[:-1] + ", 0>") if n in new), None)
            if match is None:
                print(f"{source}: {name}: no kernel of that name here")
                differ += 1
                continue
            delta = {op: new[match][op] - counts[op] for op in set(counts) | set(new[match])
                     if new[match][op] != counts[op]}
            differ += bool(delta)
            print(f"{source}: {name} vs {match}: {sum(counts.values())} instructions, "
                  + ("same" if not delta else f"differ {sorted(delta.items(), key=lambda kv: -abs(kv[1]))}"))
    print(f"kernels that differ: {differ}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
