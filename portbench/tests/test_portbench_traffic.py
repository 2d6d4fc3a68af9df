"""The traffic generator: deterministic per seed, the same work for
every seed, and the distributions a mix states."""
import json
import math
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import traffic as TR

MIXES = Path(__file__).resolve().parents[1] / "traffic"
SEEDS = (0, 2**31 + 11, 4_000_000_129)
#: the context each mix's cell serves (prompt and output together)
CONTEXT = {"reasoning-c48": 4096, "chat-poisson": 4608,
           "reasoning-c32": 4608}


def _mix(name: str) -> dict:
    with open(MIXES / f"{name}.json", encoding="utf-8") as f:
        return json.load(f)


def _key(reqs):
    return [(r.prompt.tolist(), r.max_new, r.due_s, r.client) for r in reqs]


@pytest.mark.parametrize("name", ["reasoning-c48", "chat-poisson",
                                  "reasoning-c32"])
def test_same_seed_same_requests(name):
    a = TR.generate(_mix(name), 50304, SEEDS[1], 51, CONTEXT[name])
    b = TR.generate(_mix(name), 50304, SEEDS[1], 51, CONTEXT[name])
    c = TR.generate(_mix(name), 50304, SEEDS[2], 51, CONTEXT[name])
    assert _key(a) == _key(b)
    assert _key(a) != _key(c)


@pytest.mark.parametrize("name", ["reasoning-c48", "chat-poisson",
                                  "reasoning-c32"])
def test_every_seed_gets_the_same_work(name):
    """Prompt lengths, output lengths and arrival gaps differ between
    seeds in order only."""
    runs = [TR.generate(_mix(name), 50304, s, 51, CONTEXT[name])
            for s in SEEDS]
    prompts = [sorted(r.base_prompt for r in reqs) for reqs in runs]
    outputs = [sorted(len(r.prompt) - r.base_prompt + r.max_new
                      for r in reqs) for reqs in runs]
    assert prompts[0] == prompts[1] == prompts[2]
    assert outputs[0] == outputs[1] == outputs[2]
    if _mix(name)["loop"] == "open":
        gaps = [np.sort(np.diff([0.0] + [r.due_s for r in reqs]))
                for reqs in runs]
        assert len({len(g) for g in gaps}) == 1


@pytest.mark.parametrize("dist", [
    {"dist": "loguniform", "min": 128, "max": 512},
    {"dist": "loguniform", "min": 1024, "max": 3584},
    {"dist": "loguniform", "min": 256, "max": 4096}])
def test_lengths_follow_the_stated_distribution(dist):
    x = np.sort(TR.stratified(dist, 2000))
    lo, hi = dist["min"], dist["max"]
    assert x.min() >= lo and x.max() <= hi
    cdf = (np.log(x) - math.log(lo)) / (math.log(hi) - math.log(lo))
    emp = (np.arange(len(x)) + 0.5) / len(x)
    assert np.abs(cdf - emp).max() < 0.01


def test_open_loop_arrivals_are_poisson_at_the_rate():
    mix = dict(_mix("chat-poisson"), rate_per_s=4.0)
    reqs = TR.generate(mix, 151936, SEEDS[1], 200.0, 4608)
    due = np.array([r.due_s for r in reqs])
    assert len(reqs) == 800 - 1 or len(reqs) == 800
    assert np.all(np.diff(due) >= 0) and due[-1] < 200.0
    gaps = np.diff(due)
    assert abs(gaps.mean() - 0.25) < 0.01
    # exponential: the coefficient of variation is 1
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.08


def test_bursts_raise_the_rate_inside_them():
    mix = dict(_mix("chat-poisson"), rate_per_s=4.0,
               bursts={"factor": 3, "every_s": 10, "for_s": 2})
    due = np.array([r.due_s for r in
                    TR.generate(mix, 151936, SEEDS[0], 100.0, 4608)])
    inside = np.mod(due, 10) < 2
    rate_in = inside.sum() / 20.0
    rate_out = (~inside).sum() / 80.0
    assert abs(rate_in / rate_out - 3.0) < 0.3


def test_closed_loop_callers_start_mid_generation():
    mix = _mix("reasoning-c48")
    reqs = TR.generate(mix, 50304, SEEDS[1], 51, 4096)
    c = mix["clients"]
    assert len(reqs) == c * mix["requests_per_client"]
    assert [r.client for r in reqs[:c]] == list(range(c))
    for r in reqs[:c]:
        drawn = len(r.prompt) - r.base_prompt + r.max_new
        assert 1024 <= drawn <= 3584 and r.max_new >= 1
        assert len(r.prompt) + r.max_new <= 4096
    for r in reqs[c:]:
        assert len(r.prompt) == r.base_prompt
    # the residual shares are stratified: spread over (0, 1]
    share = sorted(r.max_new / (len(r.prompt) - r.base_prompt + r.max_new)
                   for r in reqs[:c])
    assert share[0] < 0.05 and share[-1] > 0.95


def test_padded_lengths():
    reqs = [TR.Request(np.zeros(n, np.int64), 1, n) for n in (1, 16, 17, 40)]
    assert TR.padded_lengths(reqs, 16) == [16, 32, 48]

