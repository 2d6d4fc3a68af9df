"""Whether what the timed path served is correct.

Once the window has closed and the program's state is freed, a sample
of the requests the window finished, drawn from the seed with the
longest among them, is run through the plain reference (``logits`` of
the cell's architecture, ``portbench/reference/<name>.py``)
teacher-forced: its context and the tokens served, in float32.  At each
served position the gap by which the served token's logit lies below
the reference's best is read; the mean gap over the sample is compared
with the cell's limit (``portbench/limits/<cell>.json``; the widest gap
is a tail of near ties and does not separate the program from a lower
precision).  Beside it, counts that must be 0: requests that finished
other than complete, tokens outside the vocabulary, and any degradation
of the engine.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import traffic as TR


def sample(run, seed: int, budget: int) -> list:
    """The finished requests to judge: the one with the most served
    tokens, then others in the seed's order until ``budget`` served
    tokens are in the sample."""
    done = [s for s in run.served if s.outcome == "complete" and s.tokens]
    if not done:
        return []
    longest = max(done, key=lambda s: (len(s.tokens), -s.rid))
    rest = [s for s in done if s is not longest]
    order = TR.rng_for(seed, "sample").permutation(len(rest))
    out, n = [longest], len(longest.tokens)
    for i in order:
        if n >= budget:
            break
        out.append(rest[i])
        n += len(rest[i].tokens)
    return out


def _sequences(picked: list, device) -> tuple:
    seqs, rows, served = [], [], []
    for s in picked:
        ctx = np.asarray(s.req.prompt, np.int64)
        toks = np.asarray(s.tokens, np.int64)
        seq = np.concatenate([ctx, toks[:-1]])
        seqs.append(torch.from_numpy(seq).to(device))
        rows.append(torch.arange(len(ctx) - 1, len(seq), device=device))
        served.append(toks)
    return seqs, rows, torch.from_numpy(np.concatenate(served)).to(device)


def gaps(arch, m: dict, params: dict, picked: list,
         fp8_control: bool = False):
    """(the served tokens' gaps, the control's gaps or None, the float32
    reference's own logits rounded to the served type: their first
    choices' gaps) at every judged position, float32 tensors on the
    host.  A gap is how far the token's reference logit lies below the
    reference's best; the control's tokens are the first choices of the
    reference with float8 weight products.  ``arch`` is the
    architecture's module."""
    device = params["embed"].device
    seqs, rows, served = _sequences(picked, device)
    ref = arch.logits(m, params, seqs, rows)
    best = ref.max(dim=-1).values

    def gap(tokens):
        return (best - ref.gather(1, tokens[:, None])[:, 0]).cpu()
    rounded = gap(ref.to(getattr(torch, m["dtype"])).argmax(dim=-1))
    got = gap(served)
    ctl = None
    if fp8_control:
        ctl = gap(arch.logits(m, params, seqs, rows,
                              fp8=True).argmax(dim=-1))
    return got, ctl, rounded


def summary(g: torch.Tensor) -> dict:
    """The statistics of a set of gaps that the readings record."""
    g = g.double()
    return {"widest": g.max().item(), "mean": g.mean().item(),
            "p99": torch.quantile(g, 0.99).item(),
            "nonzero": (g > 0).double().mean().item(), "n": g.numel()}


def judge(run, params: dict, seed: int, limits: dict) -> tuple:
    """(correct, the compared numbers {name: (value, limit)}, notes)."""
    m = run.model
    picked = sample(run, seed, int(limits["sample_tokens"]))
    vocab_bad = sum(int(t < 0 or t >= m["vocab"])
                    for s in run.served for t in s.tokens)
    failed = sum(1 for s in run.served
                 if s.outcome is not None and s.outcome != "complete")
    degraded = (run.notes["exec_tier"] + run.notes["deny_records"]
                + sum(run.stats.get(k, 0) for k in (
                    "tier_demotions", "shadow_mismatches",
                    "golden_mismatches", "health_evictions")))
    compared = {"failed_requests": (failed, 0),
                "tokens_outside_vocab": (vocab_bad, 0),
                "degraded": (degraded, 0)}
    notes = {"judged_requests": len(picked)}
    if picked and not vocab_bad:
        got = summary(gaps(run.cell.arch, m, params, picked)[0])
        compared["mean_logit_gap"] = (got["mean"], limits["mean_logit_gap"])
        notes["judged_tokens"] = got["n"]
        notes["gaps"] = got
    else:
        # nothing finished, or a token the reference cannot read: no
        # gap can be read, and a run that served nothing checkable fails
        compared["mean_logit_gap"] = (math.inf, limits["mean_logit_gap"])
    correct = all(v <= lim for v, lim in compared.values())
    return correct, compared, notes
