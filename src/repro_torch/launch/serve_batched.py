"""Batched serving example: prefill + greedy decode over a KV cache for
any ported architecture at SMOKE size, on the card (``--device cpu``:
the plain path).

    PYTHONPATH=src python -m repro_torch.launch.serve_batched --arch mixtral-8x7b

The counterpart of the JAX package's ``examples/serve_batched.py``, with
its flags and defaults, through ``launch.serve`` (``sharded_runtime``,
``run_generate``, ``run_continuous``, ``demo_side_inputs``).  Continuous
batching — the Orca-style scheduler over a paged KV cache serves a
*ragged* workload, admitting and evicting requests every iteration:

    PYTHONPATH=src python -m repro_torch.launch.serve_batched --arch qwen3-8b --continuous

Sharded (regime-aware) serving: ``--shard-model N`` spawns N ranks
itself (gloo, every rank on the one card or on the CPU, as
``launch.serve --shard-model`` does) over a 1 x N mesh, prints the
tuner's regime choice for this job's attention shapes and rank 0's
report (composes with ``--continuous``, where the choice is
paged-spatial or paged-ring):

    PYTHONPATH=src python -m repro_torch.launch.serve_batched --shard-model 4
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import ALIASES, ARCHS, get_config
from .serve import (demo_side_inputs, run_continuous, run_generate,
                    sharded_runtime)
from .steps import build_model


def report(name: str, counts: list[int], dt: float, shard: str) -> None:
    """Honest serving report: per-request generated-token counts (early
    finish / eviction make them ragged — never assume ``--gen``)."""
    total = sum(counts)
    print(f"{name}: generated {total} tokens across {len(counts)} "
          f"requests in {dt:.2f}s ({total / dt:.1f} tok/s){shard}")
    print(f"per-request generated: {counts}")


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b",
                    choices=sorted(ALIASES) + ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--shard-model", type=int, default=1,
                    help="model-dim size; > 1 spawns that many ranks and "
                         "serves over a 1 x N mesh")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over a paged KV cache on "
                         "a ragged workload (attention-only archs)")
    ap.add_argument("--requests", type=int, default=0,
                    help="ragged-workload size for --continuous "
                         "(default 3x batch)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel path) or cpu (the plain path)")
    return ap.parse_args(argv)


def _serve(args, rank: int = 0) -> dict:
    """One rank's run of the parsed ``args``; rank 0 prints."""
    say = rank == 0
    cfg = get_config(args.arch, smoke=True)
    mesh, rules, rt = sharded_runtime(args.shard_model)
    model = build_model(cfg, rt, device=args.device)
    params = model.init_params(0)
    shard = f" [model-sharded x{args.shard_model}]" if mesh is not None \
        else ""
    if args.continuous:
        results, stats, _ = run_continuous(
            cfg, model, params, batch=args.batch,
            n_requests=args.requests or 3 * args.batch,
            prompt_len=args.prompt_len, gen=args.gen,
            page_size=args.page_size, seed=1, verbose=say)
        counts = [len(r.tokens) for r in results]
        assert all(c >= 1 for c in counts)
        if say:
            report(f"{cfg.name} [continuous, regime={stats['regime']}]",
                   counts, stats["wall_s"], shard)
            print("request 0:", results[0].tokens[:12])
        return {"mode": "continuous", "regime": stats["regime"],
                "counts": counts, "seconds": stats["wall_s"],
                "first": list(results[0].tokens[:12]),
                "tier": stats["exec_tier"]}
    g = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=g).to(model.device)
    tokens, dt = run_generate(
        model, params, prompts, args.gen, mesh=mesh, rules=rules,
        verbose=say, **demo_side_inputs(cfg, args.batch, model.device, 2))
    assert tokens.shape[0] == args.batch
    assert np.all(tokens >= 0) and np.all(tokens < cfg.vocab)
    # fixed batching decodes every request in lock-step, so each row
    # really holds tokens.shape[1] generated tokens — counted, not
    # assumed
    counts = [int(tokens.shape[1])] * args.batch
    if say:
        report(f"{cfg.name} [fixed]", counts, dt, shard)
        print("request 0:", tokens[0][:12].tolist())
    return {"mode": "fixed", "counts": counts, "seconds": dt,
            "first": tokens[0][:12].tolist()}


def _serve_rank(rank: int, argv) -> dict:
    return _serve(_parse(argv), rank)


def main(argv=None) -> dict:
    """Serves the parsed workload; returns rank 0's report as a dict:
    ``mode``, the per-request generated-token ``counts``, ``seconds``,
    request 0's ``first`` tokens (and ``regime`` with ``--continuous``)."""
    args = _parse(argv)
    if args.shard_model <= 1:
        return _serve(args)
    from .mesh import spawn
    return spawn(_serve_rank, args.shard_model, argv, device=args.device)[0]


if __name__ == "__main__":
    main()
