"""Time source variants of the two vocoder kernels against each other on the card.

    python tools/kernel_variants.py VARIANTS.json [FRAMES] [DTYPE]

VARIANTS.json maps a name to the edits that make the variant from
piper_tpu_torch/csrc/ (file -> [[old text, new text], ...]), or to
{"dir": path} for a whole other source directory ({} is the tree as it
stands). Each variant is copied under build/kernel_variants/, built, and
then timed in its own process, in turns (A B ... B A), so one variant
that hangs the card costs its own time limit (VT seconds, default 120)
and not the call. At the medium voice's stage widths and FRAMES (rows'
frame counts, default 403,396,5: chip_smoke.py's kernel phase) each run
prints one JSON line: the kernel times in DTYPE (bfloat16, the default,
or float32) of mrf_fused (stage 0) and fused_upsample_mrf stages 1 and 2
(CUDA events, 30 launches each), their largest error against the plain
versions, and a hash of both outputs' bits (variants that keep the sum
order print the same hash). The build lines print each kernel's
registers and any spills.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def time_variant(src: Path, frames, dtype_name: str) -> dict:
    import torch

    import chip_smoke as C
    from piper_tpu_torch.config import ModelConfig
    from piper_tpu_torch.models.vits import generator as G
    from piper_tpu_torch.models.vits.model import init_synthesizer_params
    from piper_tpu_torch.ops.cuda import vocoder as V
    from piper_tpu_torch.weights.bridge import params_from_jax

    from piper_tpu_torch.runtime.voice import tf32_off

    tf32_off()
    V.CSRC = src
    dtype = getattr(torch, dtype_name)
    cfg = ModelConfig.for_quality("medium", num_symbols=256)
    dec = params_from_jax(init_synthesizer_params(1, cfg), cfg, "cuda", dtype)["dec"]
    tm = G.prepare_tm(dec, cfg, dtype)
    kw = dict(kernel_sizes=tuple(cfg.resblock_kernel_sizes),
              dilation_sizes=tuple(tuple(d) for d in cfg.resblock_dilation_sizes), resblock_type=cfg.resblock)
    x0, lens0 = C.stage_inputs(cfg, frames, dtype, seed=11)
    (u1, u2), (k1, k2) = cfg.upsample_rates[1:3], cfg.upsample_kernel_sizes[1:3]
    q1, q2 = G._tm_phase_plan(k1, u1)[0], G._tm_phase_plan(k2, u2)[0]
    (w1, b1), (w2, b2) = tm["mrf"][1], tm["mrf"][2]

    def stage0(fn):
        return fn(x0, lens0, *tm["mrf"][0], **kw)

    def stage1(fn, x):
        return fn(x, lens0 * u1, tm["ups"][1], tm["ups_b"][1], w1, b1, None, u=u1, u_in=1, q0=q1, post=False, **kw)

    def stage2(fn, y):
        return fn(y, lens0 * u1 * u2, tm["ups"][2], tm["ups_b"][2], w2, b2, tm["post"], u=u2, u_in=u1, q0=q2,
                  post=True, **kw)

    with torch.inference_mode():
        x1 = stage0(V.mrf_fused).contiguous()
        y = stage1(V.fused_upsample_mrf, x1)
        out = stage2(V.fused_upsample_mrf, y)
        err = [(x1.float() - stage0(V.mrf_fused_plain).float()).abs().max().item(),
               (out.float() - stage2(V.fused_upsample_mrf_plain, y).float()).abs().max().item()]
        bits = hashlib.sha1(x1.view(torch.int16).cpu().numpy().tobytes()
                            + out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:12]
        torch.cuda.synchronize()
        ms = [C.time_ms(lambda: stage0(V.mrf_fused), reps=30), C.time_ms(lambda: stage1(V.fused_upsample_mrf, x1), reps=30),
              C.time_ms(lambda: stage2(V.fused_upsample_mrf, y), reps=30)]
    return {"dtype": dtype_name, "ms": ms, "err": err, "bits": bits, "card": torch.cuda.get_device_name(0)}


def main(argv) -> int:
    if len(argv) == 4 and argv[0] == "--one":  # a child: time one built variant
        print(json.dumps(time_variant(Path(argv[1]), [int(f) for f in argv[2].split(",")], argv[3])), flush=True)
        return 0
    if len(argv) not in (1, 2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    from piper_tpu_torch.ops.cuda import vocoder as V

    variants = json.loads(Path(argv[0]).read_text())
    frames = argv[1] if len(argv) >= 2 else "403,396,5"
    dtype = argv[2] if len(argv) == 3 else "bfloat16"
    src, dirs = ROOT / "piper_tpu_torch" / "csrc", {}
    for name, edits in variants.items():
        d = ROOT / "build" / "kernel_variants" / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(Path(edits.pop("dir")) if "dir" in edits else src, d)
        for f, pairs in edits.items():
            text = (d / f).read_text()
            for old, new in pairs:
                if old not in text:
                    raise SystemExit(f"{name}: {f} has no {old[:60]!r}")
                text = text.replace(old, new)
            (d / f).write_text(text)
        V.CSRC, dirs[name] = d, d
        V._libs.clear()
        V.BUILD_LOG.clear()
        t0 = time.time()
        V.build()
        print(f"{name}: build {time.time() - t0:.1f} s", flush=True)
        for lib, log in V.BUILD_LOG.items():
            for line in log.splitlines():
                if "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
                    print(f"  {lib}: {line.strip()}", flush=True)
    for name in list(variants) + list(variants)[::-1]:
        try:
            r = subprocess.run([sys.executable, __file__, "--one", str(dirs[name]), frames, dtype], capture_output=True,
                               text=True, timeout=int(os.environ.get("VT", "120")))
            line = r.stdout.strip().splitlines()[-1] if r.returncode == 0 else f"rc {r.returncode}: {r.stderr[-400:]}"
        except subprocess.TimeoutExpired:
            line = "time limit: the variant hung"
        print(f"{name} {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
