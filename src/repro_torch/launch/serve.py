"""Serving entry point: continuous batching over a paged KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --continuous \
        --arch qwen3-8b --batch 4 --prompt-len 64 --gen 32

The Orca-style ``serving.engine.ServingEngine`` admits, prefills,
decodes and evicts requests per iteration on a ragged workload.  The
model runs with ``Runtime(kernel_ops=True)``, so every decode step's
attention goes through the tuned CUDA kernel on the card;
``--device cpu`` is the only way to the plain path.  Weights are random
from ``--seed`` (``--full`` for the published widths, else SMOKE).
"""
from __future__ import annotations

import argparse
import math

import numpy as np

from ..configs import ALIASES, ARCHS, get_config
from ..models.lm import LM, Runtime


def ragged_workload(vocab: int, n_requests: int, prompt_len: int,
                    gen: int, seed: int = 0) -> list[tuple[np.ndarray, int]]:
    """Deterministic ragged serving workload: prompt lengths uniform in
    [prompt_len//2, prompt_len], generation budgets in [1, gen] — the
    divergence continuous batching exists to absorb."""
    rng = np.random.RandomState(seed)
    reqs = []
    for _ in range(n_requests):
        plen = int(rng.randint(max(1, prompt_len // 2), prompt_len + 1))
        g = int(rng.randint(1, gen + 1))
        reqs.append((rng.randint(0, vocab, size=plen).astype(np.int32), g))
    return reqs


def make_engine(model, params, *, batch: int, prompt_len: int, gen: int,
                page_size: int, verbose: bool = True):
    """A ``ServingEngine`` sized for ``batch`` concurrent requests of
    up to ``prompt_len + gen`` positions, with ~25% page slack so
    admission (prompt pages + one decode page of headroom) stays
    fluid without making preemption unreachable."""
    from ..serving import ServingEngine

    max_pages = math.ceil((prompt_len + gen) / page_size)
    n_pages = 1 + batch * (max_pages + 1) + max(1, batch * max_pages // 4)
    return ServingEngine(model, params, max_batch=batch,
                         page_size=page_size, n_pages=n_pages,
                         max_pages_per_seq=max_pages, verbose=verbose)


def run_continuous(cfg, model, params, *, batch: int, n_requests: int,
                   prompt_len: int, gen: int, page_size: int,
                   seed: int = 0, verbose: bool = True):
    """Continuous-batching serving of a ragged workload; returns
    (results, stats, engine)."""
    reqs = ragged_workload(cfg.vocab, n_requests, prompt_len, gen, seed)
    engine = make_engine(model, params, batch=batch,
                         prompt_len=prompt_len, gen=gen,
                         page_size=page_size, verbose=verbose)
    results, stats = engine.run(reqs)
    return results, stats, engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b",
                    choices=sorted(ALIASES) + ARCHS)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over a paged KV cache "
                         "(the only serving mode ported so far)")
    ap.add_argument("--requests", type=int, default=0,
                    help="ragged-workload size (default 4x batch)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel path) or cpu (the plain path)")
    args = ap.parse_args(argv)
    if not args.continuous:
        ap.error("fixed-batch serving is not ported yet; pass --continuous")

    cfg = get_config(args.arch, smoke=not args.full)
    model = LM(cfg, Runtime(kernel_ops=True), device=args.device)
    params = model.init_params(args.seed)
    results, stats, _ = run_continuous(
        cfg, model, params, batch=args.batch,
        n_requests=args.requests or 4 * args.batch,
        prompt_len=args.prompt_len, gen=args.gen, page_size=args.page_size,
        seed=args.seed + 1)
    counts = [len(r.tokens) for r in results]
    print(f"arch={cfg.name} continuous: {len(results)} requests, "
          f"{stats['generated']} tokens in {stats['wall_s']:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s) "
          f"steps={stats['decode_steps']} "
          f"preempt={stats['preemptions']} device={args.device}")
    print(f"per-request generated: {counts}")
    return results


if __name__ == "__main__":
    main()
