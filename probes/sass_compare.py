"""Compare the SASS of kernel sources between two checkouts.

    python3 probes/sass_compare.py --parent DIR [--out FILE] warp_gather.cu ...

Compiles each named ``csrc`` source of this checkout and of ``--parent``
(unpacked with ``git archive``) with the library's own flags
(``kernels/_build.py::NVCC_FLAGS``), dumps each object with
``cuobjdump -sass`` and compares the dumps line by line, leaving out the
hash that names each file's anonymous namespace. Prints one JSON line: for
each source, whether the two dumps are equal, their line counts and kernel
counts, and the first differing lines. Needs ``nvcc`` and ``cuobjdump``,
about two minutes.
"""
import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def sass(nvcc: str, cuobjdump: str, flags, src: Path, out: Path) -> list:
    subprocess.run([nvcc, *flags, "-c", "-o", str(out), str(src)], check=True,
                   capture_output=True)
    text = subprocess.run([cuobjdump, "-sass", str(out)], check=True, capture_output=True,
                          text=True).stdout
    # Drop the object's own file name and the hash that names the file's
    # anonymous namespace (it follows the source's text); keep every
    # function and instruction.
    return [re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", line.rstrip())
            for line in text.splitlines() if str(out) not in line]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True)
    parser.add_argument("--out", default=None)
    parser.add_argument("sources", nargs="+")
    args = parser.parse_args(argv)
    from opticalflow2d_tpu_torch.kernels import _build

    nvcc = _build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.sources:
            dumps = [sass(nvcc, cuobjdump, _build.NVCC_FLAGS,
                          root / "opticalflow2d_tpu_torch" / "csrc" / name, Path(tmp) / f"{i}.o")
                     for i, root in enumerate((Path(args.parent).resolve(), ROOT))]
            diff = [(k, a, b) for k, (a, b) in enumerate(zip(*dumps)) if a != b]
            result[name] = {"equal": dumps[0] == dumps[1], "lines": [len(d) for d in dumps],
                            "kernels": [sum("Function :" in ln for ln in d) for d in dumps],
                            "first_differences": diff[:5]}
    text = json.dumps({"sass": result})
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0 if all(r["equal"] for r in result.values()) else 1


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
