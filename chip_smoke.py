#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py                    # the whole run, as below
    python3 chip_smoke.py --kernels-only     # phases 1-3
    python3 chip_smoke.py --profile OUT_DIR  # the whole run, then a profile

from the root of a checkout. It builds the hand-written kernels from
`mvedit_tpu_torch/csrc/`, holds each against its plain PyTorch version at
the shapes the main path gives it, then drives the port's denoise slice at
the full width of SD1.5 with seeded random weights:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc of the flash-attention kernel, with ptxas' report;
3. kernel against plain version, in bf16, timed with CUDA events;
4. `run_text_to_img`: two 512^2 requests (8 DPM-Solver++ steps each);
5. the MVEdit 2-pass reference-pair denoise timestep at 6 views x 512^2,
   three timesteps, with the decoded x0 images standing in for the 3D
   renders as tile and depth hints (the 3D fuse is not ported yet).

Every phase asserts; any failure exits non-zero before the last line. The
kernels' launch counters are set to 0 before phase 4 and read after phase
5: a kernel of the path with no launch there fails the run. Without a CUDA
device the script exits non-zero and prints no result.

`--profile OUT_DIR` then runs `torch.profiler` over one warm
`run_text_to_img` request and two warm denoise timesteps, reads the trace
kernel by kernel (device busy share, time per pipeline range, per kernel
family, top kernels), prints the breakdown and writes it, with the gzipped
chrome traces, to OUT_DIR.
"""
import argparse
import gzip
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
NUM_VIEWS = 6
SIZE = 512
STEPS_T2I = 8
DENOISE_STEPS = 24     # the schedule the pipeline's timesteps come from
DENOISE_RUN = 3        # timesteps driven here
GS, TILE_W, DEPTH_W = 7.0, 1.0, 0.5   # MVEdit3DConfig's defaults
# ((B, L, H, D), q/k scale) of the kernel's calls on the path at 512^2,
# plus the other head-dim instantiations and ragged lengths. Scale 1 is
# N(0,1) q and k (nearly uniform attention; these cases are also timed),
# scale 2 a peaked softmax. The tolerance is `agreement`'s, relative to the
# reference's magnitude.
KERNEL_CASES = [
    ((6, 8192, 8, 40), 1.0),    # reference pairs, level 1 (2 x 4096 tokens)
    ((6, 4096, 8, 40), 1.0),    # uncond views, level 1
    ((12, 4096, 8, 40), 1.0),   # ControlNets on the CFG batch, level 1
    ((2, 4096, 8, 40), 1.0),    # run_text_to_img's CFG batch, level 1
    ((6, 2048, 8, 80), 1.0),    # reference pairs, level 2
    ((2, 24576, 8, 40), 1.0),   # 6-view joint attention (use_reference=False)
    ((2, 4096, 8, 64), 1.0),
    ((1, 2048, 4, 128), 1.0),
    ((1, 1000, 8, 40), 1.0),    # ragged: not on the path, on the wrapper
    ((2, 200, 8, 40), 1.0),     # ragged, 56 of the last tile's keys masked
    ((6, 8192, 8, 40), 2.0),
    ((6, 2048, 8, 80), 2.0),
    ((2, 200, 8, 40), 2.0),
]
HOT_SHAPE = (6, 8192, 8, 40)   # the shape whose times go into the JSON line
DEV = "cuda"
TIMED_RUNS = 10
R = torch.profiler.record_function   # named ranges, read by --profile


def log(*a):
    print(*a, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on the "
                 "GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return smi


def phase_build():
    from mvedit_tpu_torch.kernels import flash_attention as FA
    t0 = time.perf_counter()
    FA.build()
    log(f"[build] flash_attention.cu: {time.perf_counter() - t0:.2f} s")
    with open(FA.BUILD_LOG) as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build]   {line.strip()}")


def plain_sliced(q, k, v, budget=4 << 30):
    """The plain version over (batch, head-group) slices whose f32 score
    tensor stays under `budget` bytes: the whole 24576^2 problem would not
    fit on the card at once."""
    from mvedit_tpu_torch.kernels.flash_attention import attention_reference
    B, Lq, H, D = q.shape
    hc = max(1, min(H, budget // (4 * Lq * k.shape[1])))
    out = torch.empty_like(q)
    for b in range(B):
        for h in range(0, H, hc):
            out[b:b + 1, :, h:h + hc] = attention_reference(
                q[b:b + 1, :, h:h + hc], k[b:b + 1, :, h:h + hc],
                v[b:b + 1, :, h:h + hc])
    return out


def median_ms(fn, runs=TIMED_RUNS):
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_kernel():
    from mvedit_tpu_torch.kernels.flash_attention import (
        MAX_REL_TOL, MEAN_REL_TOL, agreement, flash_attention)
    log(f"[kernel] bounds: max|d| <= {MAX_REL_TOL:g} * max|ref|, mean|d| <= "
        f"{MEAN_REL_TOL:g} * mean|ref|")
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    rows, failed, worst = [], [], 0.0
    for shape, qk in KERNEL_CASES:
        B, L, H, D = shape
        q, k, v = (torch.randn(shape, generator=gen, device=DEV,
                               dtype=torch.bfloat16) for _ in range(3))
        q, k = q * qk, k * qk
        out = flash_attention(q, k, v)
        ref = plain_sliced(q, k, v)
        torch.cuda.synchronize()
        r = agreement(out, ref)
        line = (f"[kernel] {shape} q,k x{qk:g}: max|d| {r['max_abs']:.3e} "
                f"= {r['max_rel']:.2e} of max|ref| {r['ref_max']:.3e}; "
                f"mean|d| {r['mean_abs']:.3e} = {r['mean_rel']:.2e} of "
                f"mean|ref| {r['ref_mean']:.3e}")
        if qk == 1.0:
            ms = median_ms(lambda: flash_attention(q, k, v))
            plain_ms = median_ms(lambda: plain_sliced(q, k, v))
            flops = 4.0 * B * H * L * L * D
            line += (f"; kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s "
                     f"at the real D) plain {plain_ms:.3f} ms")
            rows.append(dict(shape=shape, ms=ms, plain_ms=plain_ms))
        log(f"{line} {'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            failed.append((shape, qk))
        worst = max(worst, r["max_abs"])
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version at {failed}")
    return rows, worst


def phase_unet_route(runner):
    """One full-size UNet call (run_text_to_img's CFG batch) through the
    kernel and again through the plain version: the whole network agrees."""
    import mvedit_tpu_torch.models.diffusion.attention as TA
    m = runner.load_stable_diffusion()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    lat = torch.randn((2, SIZE // 8, SIZE // 8, 4), generator=gen,
                      device=DEV)
    pos, neg = runner.encode_prompt(m, ["a red car"], [""])
    t = torch.full((2,), 999, dtype=torch.int32, device=DEV)
    with torch.inference_mode():
        a = m.unet(lat, t, torch.cat([neg, pos], 0))
        kernel = TA.flash_attention
        TA.flash_attention = plain_sliced
        try:
            b = m.unet(lat, t, torch.cat([neg, pos], 0))
        finally:
            TA.flash_attention = kernel
    rel = ((a - b).norm() / b.norm()).item()
    log(f"[unet] kernel vs plain attention through the SD1.5 UNet at "
        f"{SIZE}^2: relative L2 {rel:.3e}")
    # a few bf16 ulps per attention layer, carried through 16 of them
    if not (torch.isfinite(a).all().item() and rel <= 3e-2):
        raise AssertionError("UNet output through the kernel disagrees")


def phase_text_to_img(runner):
    runner.load_stable_diffusion()
    for prompt, seed in (("a red car on a hill", 1),
                         ("a wooden chair, studio light", 2)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = runner.run_text_to_img(prompt, seed=seed, steps=STEPS_T2I)
        wall = time.perf_counter() - t0
        ok = (img.shape == (SIZE, SIZE, 3) and np.isfinite(img).all()
              and img.min() >= 0.0 and img.max() <= 1.0)
        log(f"[text_to_img] {prompt!r} seed {seed}: {img.shape}, "
            f"mean {img.mean():.4f}, {wall:.3f} s wall "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("run_text_to_img output is malformed")


@torch.inference_mode()
def phase_denoise(runner, prof=None):
    """3 timesteps of `mvedit_3d.py:769-941` without the 3D fuse. `prof`, a
    scheduled `torch.profiler.profile`, is stepped after each timestep."""
    from mvedit_tpu_torch.models.diffusion import schedulers as S
    from mvedit_tpu_torch.pipelines.denoise import (DenoiseModels,
                                                    make_noise_pred_2pass)
    m = runner.load_stable_diffusion()
    cns = runner.load_controlnets(("tile", "depth"))
    N, dev = NUM_VIEWS, runner.device
    sch = m.schedule
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    images = torch.rand((N, SIZE, SIZE, 3), generator=gen, device=dev)
    pos, neg = runner.encode_prompt(m, ["a wooden chair"] * N, [""] * N)
    embeds = torch.cat([neg, pos], 0)
    # diff_bs (8) >= 6 views: the pipeline runs the whole-batch functions
    p1, p2 = make_noise_pred_2pass(DenoiseModels(
        unet=m.unet, controlnets=cns, num_views=N, use_reference=True))
    steps = S.make_timesteps(DENOISE_STEPS, sch.num_train_timesteps,
                             "trailing")
    lat0 = m.vae.encode(images * 2 - 1)
    # noise shared across views (mvedit_3d.py:609-619)
    noise, ref_noise = (torch.randn(lat0.shape[1:], generator=gen,
                                    device=dev).expand_as(lat0)
                        for _ in range(2))
    latents = S.add_noise(sch, lat0, noise, int(steps[0]))
    ref_noisy = S.add_noise(sch, lat0, ref_noise, int(steps[0]))
    state = ref_state = S.SolverState.init(latents)
    torch.cuda.reset_peak_memory_stats()
    for i in range(DENOISE_RUN):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with R("timestep"):
            t, t_prev = int(steps[i]), int(steps[i + 1])
            t_vec = torch.full((2 * N,), t, dtype=torch.int32, device=dev)
            cfg_lat = torch.cat([latents, latents], 0)
            with R("p1"):
                eps, enc_state, p1_res = p1(cfg_lat, t_vec, embeds, None,
                                            DEPTH_W, GS, ref_noisy=ref_noisy)
            sa, sn = sch.sqrt_acp(t)
            with R("vae_decode"):
                dec = m.vae.decode((latents - sn * eps) / sa)
            dec = ((dec + 1) / 2).clamp(0, 1)
            # hints from the decoded views: tile = the images, depth = their
            # gray level as a 3-channel map
            tile, depth = dec, dec.mean(-1, keepdim=True).expand_as(dec)
            with R("vae_encode"):
                eps_3d = (latents - sa * m.vae.encode(tile * 2 - 1)) / sn
            with R("p2"):
                eps_unet = p2(cfg_lat, enc_state, p1_res, t_vec, embeds,
                              torch.cat([tile, tile], 0),
                              torch.cat([depth, depth], 0),
                              TILE_W, DEPTH_W, GS, ref_noisy=ref_noisy)
            with R("solver"):
                bw = 1.0 - sa       # blend_mode="dynamic"
                latents, state = S.dpmsolver_step(
                    sch, latents, bw * eps_3d + (1 - bw) * eps_unet, t,
                    t_prev, state)
                # the reference rows stay on schedule (mvedit_3d.py:934-941)
                ref_noisy, ref_state = S.dpmsolver_step(
                    sch, ref_noisy, (ref_noisy - sa * lat0) / sn, t, t_prev,
                    ref_state)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.step()
        ok = bool(torch.isfinite(latents).all() and torch.isfinite(dec).all()
                  and torch.isfinite(ref_noisy).all())
        log(f"[denoise] timestep {i} (t={t}): {wall:.3f} s wall, latents "
            f"std {latents.std().item():.4f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("non-finite values in the denoise loop")
    peak = torch.cuda.max_memory_allocated()
    log(f"[denoise] peak memory allocated: {peak / 2**30:.2f} GiB")


# kernel families by name, first match wins
_FAMILIES = [
    ("flash kernel", r"flash_fwd_kernel"),
    ("layout transpose", r"nchwToNhwc|nhwcToNchw"),
    ("convolution", r"fprop|dgrad|conv"),
    ("matmul", r"gemm|nvjet|cutlass"),
    ("normalization", r"Moments|GroupNorm|layer_norm"),
    ("softmax", r"softmax"),
    ("copy / cast", r"copy|memcpy|memset"),
    ("elementwise", r"elementwise|upsample"),
]


def _union(intervals):
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def read_trace(path, window):
    """Kernel-by-kernel reading of a profiler chrome trace: the host wall
    of the `window` ranges, the device's busy time inside them (the union
    of kernel, memcpy and memset intervals), the device time of the
    kernels launched from inside each other named range, by kernel family,
    and the top kernels. Times in ms."""
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    wins, ranges = [], {}
    for e in ev:
        if e.get("cat") == "user_annotation":
            iv = (e["ts"], e["ts"] + e["dur"])
            if e["name"] == window:
                wins.append(iv)
            elif not e["name"].startswith("ProfilerStep"):
                ranges.setdefault(e["name"], []).append(iv)
    launched = {e["args"]["correlation"]: e["ts"] for e in ev
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    dev = [e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy",
                                            "gpu_memset")
           and any(a <= e["ts"] < b for a, b in wins)]
    busy = _union([(e["ts"], min(e["ts"] + e["dur"], b)) for e in dev
                   for a, b in wins if a <= e["ts"] < b])
    wall = sum(b - a for a, b in wins)
    per_range = {n: dict(wall_ms=sum(b - a for a, b in ivs) / 1e3,
                         device_ms=0.0, calls=len(ivs))
                 for n, ivs in ranges.items()}
    families, names = {}, {}
    for e in dev:
        t = launched.get(e.get("args", {}).get("correlation"))
        for n, ivs in ranges.items():
            if t is not None and any(a <= t <= b for a, b in ivs):
                per_range[n]["device_ms"] += e["dur"] / 1e3
        fam = next((f for f, pat in _FAMILIES
                    if re.search(pat, e["name"], re.I)), "other")
        families[fam] = families.get(fam, 0.0) + e["dur"] / 1e3
        c, ms = names.get(e["name"], (0, 0.0))
        names[e["name"]] = (c + 1, ms + e["dur"] / 1e3)
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:12]
    return dict(window=window, windows=len(wins), wall_ms=wall / 1e3,
                device_busy_ms=busy / 1e3,
                idle_share=1.0 - busy / wall if wall else None,
                device_events=len(dev), ranges=per_range,
                families=dict(sorted(families.items(), key=lambda kv: -kv[1])),
                top=[dict(name=n, count=c, ms=ms) for n, (c, ms) in top])


def _report(out_dir, label, window):
    path = os.path.join(out_dir, f"{label}.trace.json")
    r = read_trace(path, window)
    with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
        g.write(f.read())
    os.remove(path)
    with open(os.path.join(out_dir, f"{label}_summary.json"), "w") as f:
        json.dump(r, f, indent=1)
    log(f"[profile] {label}: {r['windows']} x {window!r}, host wall "
        f"{r['wall_ms']:.3f} ms, device busy {r['device_busy_ms']:.3f} ms, "
        f"idle share {r['idle_share']:.4f}, {r['device_events']} device "
        f"events")
    for n, d in r["ranges"].items():
        log(f"[profile] {label}   range {n} x{d['calls']}: host wall "
            f"{d['wall_ms']:.3f} ms, device {d['device_ms']:.3f} ms")
    for fam, ms in r["families"].items():
        log(f"[profile] {label}   family {fam}: {ms:.3f} ms")
    for t in r["top"]:
        log(f"[profile] {label}   top {t['ms']:.3f} ms x{t['count']}: "
            f"{t['name'][:100]}")


def phase_profile(runner, out_dir):
    """`torch.profiler` over one warm `run_text_to_img` request and two
    warm denoise timesteps (the first of three is the profiler's warm-up).
    The profiler's own host cost per op widens the gaps, so the idle share
    under it bounds the unprofiled one from above."""
    from torch.profiler import ProfilerActivity, profile, schedule
    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def export(label):
        return lambda p: p.export_chrome_trace(
            os.path.join(out_dir, f"{label}.trace.json"))

    with profile(activities=acts, on_trace_ready=export("text_to_img"),
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for seed in (3, 4):
            with R("request"):
                runner.run_text_to_img("a red car on a hill", seed=seed,
                                       steps=STEPS_T2I)
                torch.cuda.synchronize()
            prof.step()
    _report(out_dir, "text_to_img", "request")
    log("[profile] denoise timesteps under the profiler:")
    with profile(activities=acts, on_trace_ready=export("denoise"),
                 schedule=schedule(wait=0, warmup=1,
                                   active=DENOISE_RUN - 1,
                                   repeat=1)) as prof:
        phase_denoise(runner, prof)
    _report(out_dir, "denoise", "timestep")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-3: build the kernels and hold them "
                         "against their plain versions")
    ap.add_argument("--profile", metavar="OUT_DIR",
                    help="after the run, profile a warm request and two "
                         "warm denoise timesteps into OUT_DIR")
    args = ap.parse_args()
    smi = phase_device()
    phase_build()
    from mvedit_tpu_torch.apis import Adapter3DRunner
    from mvedit_tpu_torch.kernels.flash_attention import flash_attention
    rows, worst = phase_kernel()
    if args.kernels_only:
        log("[kernels-only] every kernel agrees with its plain version")
        return
    runner = Adapter3DRunner(seed=SEED, device=DEV)
    phase_unet_route(runner)
    # the main path: every launch from here on is the path's
    flash_attention.launches = 0
    phase_text_to_img(runner)
    t2i_launches = flash_attention.launches
    phase_denoise(runner)
    launches = flash_attention.launches
    log(f"[launches] flash_attention: {t2i_launches} in run_text_to_img, "
        f"{launches - t2i_launches} in the denoise timesteps")
    if t2i_launches == 0 or launches == t2i_launches:
        raise AssertionError("the main path did not launch flash_attention")
    if args.profile:
        phase_profile(runner, args.profile)
    hot = next(r for r in rows if r["shape"] == HOT_SHAPE)
    log(f"[kernels] ms / plain_ms below at {HOT_SHAPE}; max_abs_err over "
        f"all checked shapes")
    log(smi)
    log(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "mvedit_tpu_torch/csrc/flash_attention.cu",
        "replaces": "mvedit_tpu/models/diffusion/attention.py:111",
        "launches": launches, "max_abs_err": worst, "ms": hot["ms"],
        "plain_ms": hot["plain_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
