"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA card (Hopper, sm_90a) and runs from a checkout of the
repo; it fails, printing no result, without either.  Phases, each of
which raises on failure:

1. device: the card's name and power limit; TF32 off;
2. build: every CUDA kernel of ``src/repro_torch/kernels/csrc`` compiled
   with nvcc from the checkout, all sources at once;
3. every kernel against its plain PyTorch version on the card, at the
   main path's shapes, with the tolerance stated per dtype;
4. the main path: qwen3-8b at full width (36 layers, bf16, random
   weights from a seed) served by the continuous-batching engine with
   ``Runtime(kernel_ops=True)`` — 8 ragged requests, max batch 4; the
   kernel's launch counter must equal decode steps x layers, and one
   decode step through the kernel must agree with the same step
   through the plain attention;
5. a profile of that decode step: host wall time and device time by
   kernel;
6. times of each kernel beside its bound, its plain version and the
   one PyTorch call that computes the same function.

Prints a ``{"kernels": [...]}`` line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12            # H100 SXM datasheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: dict(rtol=3e-4, atol=1e-3),   # f32 sum order
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}  # P rounded to bf16
# The kernel rounds the unnormalised P to bf16, the plain attention the
# normalised P; 36 bf16 layers carry that difference to the logits
# (0.018 relative on an H100), far below what a wrong kernel gives
# (order 1)
E2E_REL_TOL = 5e-2

SERVE = dict(batch=4, n_requests=8, prompt_len=128, gen=32, page_size=16,
             seed=1)


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"capability={torch.cuda.get_device_capability(0)} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    return smi


def build_phase() -> None:
    from repro_torch.kernels import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {n: pool.submit(_build.build, n) for n in names}
        for n, fut in futures.items():
            path, log = fut.result()
            regs = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln]
            print(f"build {n}: {path.name} {regs}")
    print(f"build seconds: {time.perf_counter() - t0:.2f}")


def _attn_inputs(dtype, b, hq, hkv, m, n, d, seed, per_request=True):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, hq, m, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, hkv, n, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, hkv, n, d, generator=g, device="cuda").to(dtype)
    if per_request:
        kv_pos = torch.arange(n, dtype=torch.int32, device="cuda").repeat(
            b, 1)
        q_pos = (n - m + torch.arange(m, dtype=torch.int32, device="cuda")
                 ).repeat(b, 1)
    else:
        kv_pos = torch.arange(n, dtype=torch.int32, device="cuda")
        q_pos = n - m + torch.arange(m, dtype=torch.int32, device="cuda")
    return q, k, v, kv_pos, q_pos


def kernel_check_phase(n_ctx: int, tiles: tuple) -> float:
    """The CUDA kernel against its plain version on the card; returns
    the largest absolute error over all cases."""
    from repro_torch.kernels import attention as A
    bq, bkv = tiles
    worst = 0.0
    cases = [  # (name, dtype, m, n, bq, bkv, window, edit)
        ("decode bf16", torch.bfloat16, 1, n_ctx, bq, bkv, 0, None),
        ("decode f32", torch.float32, 1, n_ctx, bq, bkv, 0, None),
        ("ragged+dead", torch.bfloat16, 1, n_ctx, bq, 32, 0, "ragged"),
        ("window", torch.bfloat16, 1, n_ctx, bq, 32, 40, "ragged"),
        ("m>1 bq>1", torch.float32, 8, 96, 4, 32, 0, None),
        ("n=200", torch.bfloat16, 1, 200, 1, 128, 0, None),
    ]
    for i, (name, dt, m, n, bq_, bkv_, window, edit) in enumerate(cases):
        q, k, v, kv_pos, q_pos = _attn_inputs(dt, 4, 32, 8, m, n, 128, i)
        if edit == "ragged":
            kv_pos[1, 17:40] = A.INVALID_POS     # unallocated slots
            q_pos[0, 0] = 90                     # a shorter request
            q_pos[2, 0] = -1                     # inactive slot: dead row
        got = A.fused_attention_partial(q, k, v, kv_pos, q_pos, bq=bq_,
                                        bkv=bkv_, causal=True,
                                        window=window)
        torch.cuda.synchronize()
        _, bkv_c = A.clamp_tiles(m, n, bq_, bkv_)
        want = A.fused_attention_partial_plain(q, k, v, kv_pos, q_pos,
                                               bkv_c, True, window,
                                               128 ** -0.5)
        err = 0.0
        for x, w in zip(got, want):
            torch.testing.assert_close(x, w, **TOL[dt])
            err = max(err, float((x - w).abs().max()))
        if edit == "ragged" and float(got[2][2, :, 0].abs().max()) != 0.0:
            raise RuntimeError("a dead row did not emit l = 0")
        worst = max(worst, err)
        print(f"kernel vs plain [{name}] m={m} n={n} tiles=({bq_},{bkv_}) "
              f"{str(dt)[6:]}: max|err|={err:.3g} tol={TOL[dt]} ok")
    return worst


def serve_phase(cfg):
    from repro_torch.kernels import attention as A
    from repro_torch.launch.serve import run_continuous
    from repro_torch.models.lm import LM, Runtime
    model = LM(cfg, Runtime(kernel_ops=True), device="cuda")
    t0 = time.perf_counter()
    params = model.init_params(0)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"model: {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.dh} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} {cfg.dtype} weights={n_bytes / 1e9:.2f} GB "
          f"(init {time.perf_counter() - t0:.1f}s, no depth cut)")
    A.fused_attention_partial.launches = 0
    results, stats, engine = run_continuous(cfg, model, params, **SERVE,
                                            verbose=True)
    torch.cuda.synchronize()
    launches = A.fused_attention_partial.launches
    bq, bkv = engine.model.rt.paged_block
    print(f"tuner paged tiles: bq={bq} bkv={bkv} "
          f"(schedule from {engine.regime_source})")
    print(f"served: {len(results)} requests finished, "
          f"{stats['generated']} tokens, {stats['decode_steps']} decode "
          f"steps, {stats['prefills']} prefills, "
          f"{stats['preemptions']} preemptions, "
          f"{stats['tok_per_s']:.2f} tok/s ({stats['wall_s']:.2f}s)")
    want = stats["decode_steps"] * cfg.n_layers
    print(f"fused_attention_partial launches: {launches} "
          f"(decode steps x layers = {want})")
    if launches != want or launches == 0:
        raise RuntimeError("the main path did not run the kernel once per "
                           "layer per decode step")
    budgets = [g for _, g in _workload(cfg)]
    if [len(r.tokens) for r in results] != budgets or any(
            r.outcome != "complete" for r in results):
        raise RuntimeError("a request did not complete its budget")
    if any(not 0 <= t < cfg.vocab for r in results for t in r.tokens):
        raise RuntimeError("a token outside the vocabulary")
    return params, engine, launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _workload(cfg):
    from repro_torch.launch.serve import ragged_workload
    return ragged_workload(cfg.vocab, SERVE["n_requests"],
                           SERVE["prompt_len"], SERVE["gen"], SERVE["seed"])


def end_to_end_check(cfg, params, engine):
    """One full-width decode step of two requests through the kernel
    (with the engine's tuned tiles), and the same step through the
    plain attention: finite logits of the expected shape that agree
    within E2E_REL_TOL.  Returns the step's (model, cache, inputs)."""
    from repro_torch.models.lm import LM, Runtime
    from repro_torch.serving import kv_pages as KP
    model = engine.model
    plain = LM(cfg, Runtime(kernel_ops=False), device="cuda")
    ps, mp = engine.page_size, engine.max_pages
    pool = KP.PagePool(engine.pool.n_pages, ps)
    cache = model.init_paged_cache(engine.pool.n_pages, ps)
    reqs = _workload(cfg)[:2]
    allocs, last, lengths = [], [], []
    for prompt, _ in reqs:
        a = KP.RequestPages()
        if not a.ensure(len(prompt) + 1, pool):
            raise RuntimeError("the check's page pool is too small")
        toks = torch.zeros((1, math.ceil(len(prompt) / ps) * ps),
                           dtype=torch.long, device="cuda")
        toks[0, :len(prompt)] = torch.from_numpy(prompt).long()
        logits, cache = model.prefill_paged(
            params, toks, cache,
            torch.from_numpy(KP.table_array([a], mp)).cuda(), len(prompt))
        allocs.append(a)
        last.append(int(torch.argmax(logits[0])))
        lengths.append(len(prompt))
    args = (torch.tensor(last, device="cuda"),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"),
            torch.from_numpy(KP.table_array(allocs, mp)).cuda())
    got, cache = model.decode_step_paged(params, cache, *args)
    want, cache = plain.decode_step_paged(params, cache, *args)
    torch.cuda.synchronize()
    if got.shape != (2, cfg.vocab) or not torch.isfinite(got).all():
        raise RuntimeError(f"bad logits {tuple(got.shape)}")
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    agree = (got.argmax(-1) == want.argmax(-1)).tolist()
    print(f"end-to-end decode step, kernel vs plain attention at full "
          f"width: rel err {rel:.3g} (tol {E2E_REL_TOL}), "
          f"argmax agree {agree}")
    if rel > E2E_REL_TOL:
        raise RuntimeError("kernel path diverges from the plain path")
    return model, cache, args


def profile_phase(params, model, cache, args) -> None:
    """Where one full-width decode step's time goes: host wall per step
    (synchronised, no profiler), then device time by kernel over three
    steps from torch.profiler.  Re-running the step rewrites the same kv
    slots, so every step sees the same state."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def step():
        model.decode_step_paged(params, cache, *args)
        torch.cuda.synchronize()

    step()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    wall_ms = (time.perf_counter() - t0) / 5 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
    # kernel rows only: an operator's row repeats its kernels' time
    rows = [(e.self_device_time_total / 3e3, e.count // 3, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"profile: decode step (batch 2, {len(params['layers'])} layers) "
          f"wall {wall_ms:.3f} ms "
          f"without profiler; device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of the wall)")
    for ms, count, name in rows[:8]:
        print(f"profile:   {ms:8.3f} ms  {count:5d}x  {name[:90]}")


def _time_ms(fn, iters: int = 20, reps: int = 10) -> float:
    """Device milliseconds of one ``fn()``: ``iters`` calls captured in a
    CUDA graph and replayed ``reps`` times between two events, so the
    host's launch overhead (larger than a decode-size kernel) is not
    what is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def time_phase(n: int, tiles: tuple, label: str) -> dict:
    """kernel_ms, bound_ms, plain_ms and library_ms of the partial
    attention at B=4, Hq=32, Hkv=8, M=1, D=128, bf16 over N slots."""
    from repro_torch.kernels import attention as A
    b, hq, hkv, m, d, dt = 4, 32, 8, 1, 128, torch.bfloat16
    q, k, v, kv_pos, q_pos = _attn_inputs(dt, b, hq, hkv, m, n, d, 99)
    bq, bkv = A.clamp_tiles(m, n, *tiles)
    scale = d ** -0.5
    kernel_ms = _time_ms(lambda: A.fused_attention_partial(
        q, k, v, kv_pos, q_pos, bq=bq, bkv=bkv, causal=True, scale=scale))
    plain_ms = _time_ms(lambda: A.fused_attention_partial_plain(
        q, k, v, kv_pos, q_pos, bkv, True, 0, scale))
    mask = (kv_pos[:, None, None, :] <= q_pos[:, None, :, None])
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale, enable_gqa=True))
    in_bytes = sum(t.numel() * t.element_size()
                   for t in (q, k, v, kv_pos, q_pos))
    out_bytes = (b * hq * m * d + 2 * b * hq * m) * 4
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * b * hq * m * n * d / PEAK_OPS[dt] * 1e3
    out = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               tiles=[bq, bkv])
    print(f"times [{label}] B={b} Hq={hq} Hkv={hkv} M={m} N={n} D={d} bf16 "
          f"tiles=({bq},{bkv}): " + json.dumps(out))
    return out


def main() -> None:
    smi = device_phase()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    # tuned schedules persist inside the checkout (.cache/ is gitignored)
    os.environ.setdefault("REPRO_TORCH_CACHE_DIR",
                          os.path.join(ROOT, ".cache", "schedules"))
    from repro_torch.configs import get_config
    from repro_torch.core import api
    build_phase()
    cfg = get_config("qwen3-8b")
    n_ctx = SERVE["page_size"] * math.ceil(
        (SERVE["prompt_len"] + SERVE["gen"]) / SERVE["page_size"])
    tuned = {n: api.fuse_attention_paged(
        1, n, cfg.dh, cfg.dh, page_size=SERVE["page_size"],
        heads=cfg.n_heads, batch=SERVE["batch"], dtype=cfg.dtype).params
        for n in (n_ctx, 4096)}
    decode_tiles = (tuned[n_ctx].bq, tuned[n_ctx].bkv)
    max_err = kernel_check_phase(n_ctx, decode_tiles)
    params, engine, launches = serve_phase(cfg)
    if engine.model.rt.paged_block != decode_tiles:
        raise RuntimeError("the engine ran other tiles than the tuner's")
    profile_phase(params, *end_to_end_check(cfg, params, engine))
    del params, engine
    torch.cuda.empty_cache()
    t_dec = time_phase(n_ctx, decode_tiles, "slice decode")
    time_phase(4096, (tuned[4096].bq, tuned[4096].bkv), "long decode")
    kernels = [{
        "name": "fused_attention_partial",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/attention_partial.cu",
        "replaces": "src/repro/kernels/attention.py:160",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t_dec["kernel_ms"],
        "plain_ms": t_dec["plain_ms"],
        "bound_ms": t_dec["bound_ms"],
        "bound_by": t_dec["bound_by"],
        "library_ms": t_dec["library_ms"],
        "passed": True,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
