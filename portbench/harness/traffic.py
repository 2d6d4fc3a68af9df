"""The one traffic generator: a mix is a JSON file of parameters
(``portbench/traffic/<mix>.json``) that this module reads.

Every seed gets the same amount of work.  Lengths are the stratified
quantiles of their distribution (the i-th of n at probability
(i + 0.5) / n) and gaps between arrivals the stratified quantiles of
the exponential; the seed draws only their order, the prompt tokens
and whatever the configuration's weights draw.  So two seeds differ in
which request comes when, not in how much there is to do.

Parameters of a mix:

- ``loop``: ``"closed"`` (``clients`` callers, each sending its next
  request when the last one finished, ``requests_per_client`` drawn
  for each) or ``"open"`` (arrivals at ``rate_per_s`` on average,
  Poisson, whatever the system does).
- ``prompt`` and ``output``: ``{"dist": "loguniform", "min", "max"}``
  in tokens.
- ``first_request`` (closed loop): ``"mid_generation"`` starts each
  client's first request part-way through its output, as a caller
  found in steady state: a residual budget drawn uniformly up to its
  output length, and a context already holding its prompt and the
  tokens it has generated so far (stand-in tokens).
- ``bursts`` (open loop, optional): ``{"factor", "every_s", "for_s"}``,
  the rate multiplied by ``factor`` for the first ``for_s`` seconds of
  every ``every_s``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # token ids, the context before serving
    max_new: int                # output budget
    base_prompt: int            # the mix's drawn prompt length
    due_s: float = 0.0          # open loop: seconds after the window
    client: int = -1            # opens; closed loop: its caller


def stratified(dist: dict, n: int) -> np.ndarray:
    """The n stratified quantiles of ``dist``, rounded to whole tokens,
    ascending."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = float(dist["min"]), float(dist["max"])
    if dist["dist"] != "loguniform":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    x = np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator for one use of the run's seed."""
    tag = [ord(c) for c in stream]
    return np.random.default_rng(np.random.SeedSequence([seed % 2**63,
                                                         *tag]))


def _arrivals(mix: dict, seconds: float, rng) -> np.ndarray:
    """Due times in [0, seconds): a unit-rate process of stratified
    exponential gaps, in the seed's order, mapped through the inverse of
    the mix's cumulative rate."""
    rate = float(mix["rate_per_s"])
    grid = np.linspace(0.0, seconds, int(seconds * 1000) + 1)
    r = np.full_like(grid, rate)
    b = mix.get("bursts")
    if b:
        r = np.where(np.mod(grid, b["every_s"]) < b["for_s"],
                     rate * b["factor"], rate)
    cum = np.concatenate([[0.0], np.cumsum((r[1:] + r[:-1]) / 2
                                           * np.diff(grid))])
    n = int(math.floor(cum[-1]))
    if n < 1:
        return np.zeros(0)
    u = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-u))
    # the stratified gaps sum to about n, spread over the unit-rate span
    unit = np.cumsum(gaps) * (cum[-1] / gaps.sum()) - gaps[0] / 2
    due = np.interp(unit, cum, grid)
    return due[due < seconds]


def generate(mix: dict, vocab: int, seed: int, seconds: float,
             max_context: int) -> list[Request]:
    """The run's requests: for a closed loop, ``clients *
    requests_per_client`` in each client's order (``client`` set); for
    an open loop, those due inside the window, by due time."""
    rng = rng_for(seed, "traffic")
    if mix["loop"] == "closed":
        c = int(mix["clients"])
        n = c * int(mix["requests_per_client"])
        due = None
    elif mix["loop"] == "open":
        due = _arrivals(mix, seconds, rng)
        n = len(due)
    else:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    plen = rng.permutation(stratified(mix["prompt"], n))
    olen = rng.permutation(stratified(mix["output"], n))
    if int((plen + olen).max(initial=0)) > max_context:
        raise ValueError(f"a request of {int((plen + olen).max())} "
                         f"positions exceeds the context {max_context}")
    reqs = []
    for i in range(n):
        toks = rng.integers(0, vocab, int(plen[i]), dtype=np.int64)
        r = Request(toks, int(olen[i]), int(plen[i]))
        if due is not None:
            r.due_s = float(due[i])
        else:
            r.client = i % c
        reqs.append(r)
    if due is None and mix.get("first_request") == "mid_generation":
        # stratified residual shares, one per client, in the seed's order
        share = rng.permutation((np.arange(c) + 0.5) / c)
        for i in range(c):
            r = reqs[i]
            left = max(1, int(math.ceil(share[i] * r.max_new)))
            done = r.max_new - left
            r.prompt = np.concatenate(
                [r.prompt, rng.integers(0, vocab, done, dtype=np.int64)])
            r.max_new = left
    return reqs


def padded_lengths(reqs: list[Request], page: int) -> list[int]:
    """The distinct prompt lengths the engine's prefill sees (each
    prompt padded to a page multiple), ascending."""
    return sorted({int(math.ceil(len(r.prompt) / page)) * page
                   for r in reqs})
