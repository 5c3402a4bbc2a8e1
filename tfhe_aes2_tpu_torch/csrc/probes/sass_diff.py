"""Compare the machine code (SASS) of two checkouts' kernel builds, kernel
by kernel, on the machine with the card and the CUDA toolkit:

    python3 tfhe_aes2_tpu_torch/csrc/probes/sass_diff.py ROOT_A ROOT_B

Builds the kernels of both checkouts (each into its own
tfhe_aes2_tpu_torch/_build/), disassembles every library with
`cuobjdump -sass`, and matches functions by their code, not by their name (a
template parameter added to a kernel renames it): two functions are the same
when their instructions are, once the address and encoding comments are
taken out. For each source it prints how many of A's functions have a twin
in B, and names A's functions without one and B's functions without one.
A change that claims to leave a kernel's code as it was is checked here:
its instantiations must all have twins.
"""

import hashlib
import re
import subprocess
import sys
from pathlib import Path

FIND = """import sys
sys.path.insert(0, sys.argv[1])
from tfhe_aes2_tpu_torch.ops.kernels import build
build.build_all()
print(build.BUILD_DIR, build._digest(), *build.SOURCES)
"""
COMMENT = re.compile(r"/\*[^*]*\*/")


def built(root: str):
    """Build the checkout at `root`; returns {stem: library path}."""
    out = subprocess.run([sys.executable, "-c", FIND, root], check=True,
                         capture_output=True, text=True).stdout.split()
    build_dir, tag, sources = Path(out[0]), out[1], out[2:]
    return {Path(s).stem: build_dir / f"lib{Path(s).stem}-{tag}.so"
            for s in sources}


def functions(lib: Path) -> dict:
    """{code hash: function name} of every function in the library."""
    cuobjdump = "/usr/local/cuda/bin/cuobjdump"
    if not Path(cuobjdump).exists():
        cuobjdump = "cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    found, name, body = {}, None, []
    for line in text.splitlines() + ["Function : <end>"]:
        if "Function : " in line:
            if name is not None:
                code = "\n".join(body).encode()
                found.setdefault(hashlib.sha256(code).hexdigest(), name)
            name, body = line.split("Function : ", 1)[1].strip(), []
        elif name is not None:
            ins = COMMENT.sub("", line).strip()
            if ins:
                body.append(ins)
    return found


def main() -> int:
    a, b = built(sys.argv[1]), built(sys.argv[2])
    same_all = True
    for stem in sorted(set(a) | set(b)):
        fa = functions(a[stem]) if stem in a else {}
        fb = functions(b[stem]) if stem in b else {}
        only_a = sorted(fa[h] for h in fa.keys() - fb.keys())
        only_b = sorted(fb[h] for h in fb.keys() - fa.keys())
        print(f"{stem}: {len(fa.keys() & fb.keys())} of A's {len(fa)} "
              f"functions have a twin in B ({len(fb)} functions)")
        for name in only_a:
            print(f"  A only: {name}")
        for name in only_b:
            print(f"  B only: {name}")
        same_all &= not only_a
    print("every function of A has a twin in B" if same_all
          else "some functions of A have no twin in B")
    return 0


if __name__ == "__main__":
    sys.exit(main())
