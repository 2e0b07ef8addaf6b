"""The serving forward of this tree beside another tree's, in turns on one
card (other, this, this, other): ms per forward of the default model
(``attention_impl="pallas"``, seeded weights) at 16 and 128 windows, bf16
and f32, median and quartiles of 20 forwards timed by CUDA events after 3
warm ones.  Each turn is a process of its own that imports its tree's
package; the trees share one kernel build when their CUDA sources match.
Made to read what routing kernels 1 and 2 through ``torch.library`` custom
operators costs against calling their entries directly.

    python3 tools/torch_dispatch_turns.py --other build/archive/parent [--out build/smoke]
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys, time
import numpy as np, torch
sys.path.insert(0, {tree!r})
from audio_to_midi_tpu_torch.config import DEFAULT_CONFIG as cfg
from audio_to_midi_tpu_torch.infer import _parity_precision
from audio_to_midi_tpu_torch.models import model as model_lib
from audio_to_midi_tpu_torch.ops import attention_kernels as ak

assert model_lib.__file__.startswith({tree!r}), model_lib.__file__
base = model_lib.Model(cfg.model, torch.Generator().manual_seed(0)).cuda().eval()
rope = model_lib.make_rope(cfg.model, "cuda")
out = {{}}
for windows in (16, 128):
    x = (torch.randn(windows, 2, 80_000, generator=torch.Generator().manual_seed(1)) * 0.5).cuda()
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        m = base if dt == torch.float32 else model_lib.cast_params(
            __import__("copy").deepcopy(base), dt)
        times = []
        with torch.inference_mode(), _parity_precision(dt):
            for i in range(23):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                model_lib.forward(m, cfg.model, x.to(dt), rope)
                end.record()
                torch.cuda.synchronize()
                if i >= 3:
                    times.append(start.elapsed_time(end))
        q1, med, q3 = np.percentile(times, [25, 50, 75])
        out[f"{{windows}} {{name}}"] = {{"median_ms": float(med), "q1": float(q1),
                                       "q3": float(q3)}}
out["launches"] = {{"global_attention": ak.global_attention.launches,
                   "local_two_phase": ak.local_two_phase.launches}}
print(json.dumps(out))
"""


def _share_build(other: Path) -> None:
    """Copy this tree's kernel library into the other's build directory
    where the two trees' CUDA sources are the same (the same file name)."""
    sys.path.insert(0, str(ROOT))
    from audio_to_midi_tpu_torch.ops import cuda_build

    lib = cuda_build.build()
    target = other / "build" / "torch_kernels" / lib.name
    if (other / "audio_to_midi_tpu_torch" / "csrc").exists():
        target.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(lib, target)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--other", required=True, help="The other tree's root")
    p.add_argument("--out", default="build/smoke")
    args = p.parse_args(argv)
    other = Path(args.other).resolve()
    _share_build(other)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    turns = []
    for name, tree in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        proc = subprocess.run([sys.executable, "-c", CHILD.format(tree=str(tree))], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append({"tree": name, **result})
        print(name, json.dumps(result), flush=True)
    for key in [k for k in turns[0] if k not in ("tree", "launches")]:
        row = ", ".join(f"{t['tree']} {t[key]['median_ms']:.3f} ({t[key]['q1']:.3f}-"
                        f"{t[key]['q3']:.3f})" for t in turns)
        print(f"forward {key}, ms: {row}", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "dispatch_turns.json").write_text(json.dumps({"card": card, "turns": turns}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
