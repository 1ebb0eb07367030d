"""Where K1's f32 variant spends its time, measured on the card.

Builds ``csrc/flash_fwd.cu`` three times into ``build/f32_breakdown/``:
as it is; with its products taken out (each ``mma.sync`` triple replaced
by integer operations on all of its split operands, so every load and
split stays); and with its tile work taken out (each kv tile read once
from shared memory: the copies, the waits and the epilogue stay). It
times the three on the same inputs at the int8 ViT shape (1024, 4, 65,
65, 32) f32 as CUDA graphs, in turns, and prints one JSON line. The two
cut builds give wrong outputs; they measure time only. Run on a machine
with the card, from the root of a checkout:

    python -m rafiki_torch.ops.f32_breakdown
"""

from __future__ import annotations

import ctypes
import json
import subprocess

from . import _build

# Every split operand of one mma.sync triple, folded into one word.
_FOLD = " ^ ".join([f"{{a}}[{i}][{j}]" for i in range(2) for j in range(4)]
                   + [f"b[{i}][{j}]" for i in range(2) for j in range(2)])

# Statements of csrc/flash_fwd.cu (each on lines of its own, indentation
# aside) -> their replacement in each cut build.
CUTS = {
    "no_products": {
        "mma3(d, a, b);":
            "d[0] = __uint_as_float(" + _FOLD.format(a="a") + ");",
        "mma3(acc[d], pa, b);":
            "acc[d][0] += __uint_as_float(" + _FOLD.format(a="pa") + ");",
    },
    "copies_only": {
        "if (nc < NC)\n"
        "tile(no{}, yes{});  // a trimmed tile is masked: keys past Tkv\n"
        "else if (masked)\n"
        "tile(yes{}, yes{});\n"
        "else\n"
        "tile(yes{}, no{});":
            "if (masked && nc < 0) tile(no{}, yes{});\n"
            "acc[0][0] += Kt[lane] + Vt[lane];",
    },
}


def _cut(text, old, new):
    """``text`` with the lines that read ``old`` (indentation aside)
    replaced by ``new``; exactly one such place must exist."""
    lines = text.split("\n")
    olds = old.split("\n")
    hits = [i for i in range(len(lines) - len(olds) + 1)
            if [x.strip() for x in lines[i:i + len(olds)]] == olds]
    if len(hits) != 1:
        raise RuntimeError(f"the source has {old!r} {len(hits)} times")
    i = hits[0]
    pad = lines[i][:len(lines[i]) - len(lines[i].lstrip())]
    return "\n".join(lines[:i] + [pad + x for x in new.split("\n")]
                     + lines[i + len(olds):])


def _sources():
    """(name, source text) of the three builds."""
    text = (_build.CSRC / "flash_fwd.cu").read_text()
    for header in ("flash_common.cuh", "flash_hopper.cuh"):
        text = text.replace(f'#include "{header}"',
                            f'#include "{_build.CSRC / header}"')
    out = [("kernel", text)]
    for name, edits in CUTS.items():
        cut = text
        for old, new in edits.items():
            cut = _cut(cut, old, new)
        out.append((name, cut))
    return out


def _build_all(where):
    """Compile the three builds at once; {name: bound entry point}."""
    where.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in _sources():
        src = where / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(where / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(where / f"lib{name}.so")).flash_fwd
        fn.argtypes = _build._ENTRY["flash_fwd"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> None:
    import torch

    from rafiki_torch.torchenv import graph_capture

    fns = _build_all(_build.BUILD_DIR.parent / "f32_breakdown")
    b, h, t, d = 1024, 4, 65, 32
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
               for _ in range(3))
    o = torch.empty_like(q)
    lse = torch.empty(b, h, t, device="cuda")

    def launch(fn):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                 o.data_ptr(), lse.data_ptr(), b, h, t, t, d, 0, 0, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def graph_ms(fn, n=20):
        for _ in range(2):
            launch(fn)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with graph_capture(graph):
            for _ in range(n):
                launch(fn)
        graph.replay()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    order = list(fns) + list(fns)[::-1]
    runs = {name: [] for name in fns}
    for name in order:
        runs[name].append(graph_ms(fns[name]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"f32_breakdown_ms": {
        name: sum(r) / len(r) for name, r in runs.items()},
        "shape": [b, h, t, t, d], "order": order, "card": card}),
        flush=True)


if __name__ == "__main__":
    main()
