#!/usr/bin/env python3
"""Compare the machine code (SASS) of every CUDA kernel two checkouts of
the repository build, on a machine with the CUDA toolkit.

Run from the repository root::

    python3 chip_sass_diff.py FIRST SECOND

FIRST and SECOND are directories holding ``paddle_tpu_torch/`` (for
example the parent commit unpacked with ``git archive`` into a git-ignored
directory, and this checkout).  Each builds its libraries of
``paddle_tpu_torch/csrc/`` in a process of its own (``_build.build``);
``cuobjdump -sass`` then lists each library's kernels, and a kernel both
build is compared instruction by instruction (names taken without the
anonymous namespace's per-build hash).  Prints one JSON object: for each
library, how many kernels are identical, which differ, and which only one
checkout builds; a library only one checkout builds (a float16 variant,
``_build.VARIANTS``) is listed with its kernel count.  Lines are
compared with their runs of blanks made one (``cuobjdump``'s column
padding follows the library's other kernels, so a kernel added to a
library can move the columns of the rest); a kernel that differs names
its first differing line.  A change that must leave a kernel as it was shows it
here without timing noise.  Exits non-zero without a toolkit.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

# the anonymous namespace's mangled name carries a hash of the build
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def libraries(checkout: str) -> dict:
    """{library: built library path} of ``checkout`` (every library its
    ``_build`` lists), built in a process of its own (both checkouts'
    packages are named alike)."""
    code = ("import json, sys; sys.path.insert(0, %r); "
            "from paddle_tpu_torch.ops.cuda import _build; _build.build(); "
            "names = getattr(_build, 'LIBRARIES', _build.SOURCES); "
            "print(json.dumps({n: str(_build._library(n)) for n in names}))"
            % str(Path(checkout).resolve()))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def kernels(cuobjdump: str, path: str) -> dict:
    """{kernel name: [SASS lines]} of one library."""
    text = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = ANON.sub("_", m.group(1))
            out[cur] = []
        elif cur is not None and "/*" in line:
            out[cur].append(" ".join(line.split()))
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        print("usage: python3 chip_sass_diff.py FIRST SECOND",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from paddle_tpu_torch.ops.cuda import _build
    try:
        cuobjdump = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    except RuntimeError as e:
        print(f"chip_sass_diff: {e}", file=sys.stderr)
        return 2
    first, second = (libraries(c) for c in args)
    report = {}
    for name in sorted(set(first) | set(second)):
        if name not in first or name not in second:
            side = "second" if name in second else "first"
            path = (second if name in second else first)[name]
            report[name] = {f"library_only_in_{side}":
                            len(kernels(cuobjdump, path))}
            continue
        a, b = kernels(cuobjdump, first[name]), kernels(cuobjdump,
                                                        second[name])
        both = sorted(set(a) & set(b))
        differ = [k for k in both if a[k] != b[k]]
        report[name] = {
            "identical": len(both) - len(differ),
            "differ": {k: next(([x, y] for x, y in zip(a[k], b[k])
                                if x != y), "lengths differ")
                       for k in differ},
            "only_in_first": sorted(set(a) - set(b)),
            "only_in_second": sorted(set(b) - set(a))}
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
