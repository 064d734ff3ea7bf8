"""The traffic generator: determinism by seed, the same sizes for every
seed, and the distributions' ranges and means."""
import json
import math

import numpy as np

from harness import spec
from harness.traffic import Traffic, quantile, residual_quantile, stratified

CHAT = json.loads((spec.BENCH_DIR / "traffic" / "chat-closed.json").read_text())
BIG = 2**31 + 987654321


def test_same_seed_same_requests():
    mix = CHAT
    a, b = Traffic(mix, 49152, BIG), Traffic(mix, 49152, BIG)
    for i in (0, 5, 70):
        ra, rb = a.request(i), b.request(i)
        assert (ra.prompt, ra.max_new, ra.seed) == (rb.prompt, rb.max_new, rb.seed)
    assert a.initial_request(3) == b.initial_request(3)
    c = Traffic(mix, 49152, BIG + 1)
    assert c.request(0).prompt != a.request(0).prompt


def test_every_seed_gets_the_same_sizes():
    mix = CHAT
    n = mix["block"]
    sizes = []
    for seed in (1, 2, BIG):
        t = Traffic(mix, 512, seed)
        sizes.append(sorted((len(t.request(i).prompt), t.request(i).max_new) for i in range(n)))
        order = [len(t.request(i).prompt) for i in range(n)]
    assert sorted(s[0] for s in sizes[0]) == sorted(s[0] for s in sizes[1]) == sorted(s[0] for s in sizes[2])
    assert sorted(s[1] for s in sizes[0]) == sorted(s[1] for s in sizes[2])
    assert order != sorted(order)  # permuted, not sorted


def test_lengths_in_range_and_token_ids_in_vocab():
    t = Traffic(CHAT, 300, 7)
    for i in range(200):
        r = t.request(i)
        assert 64 <= len(r.prompt) <= 512 and 32 <= r.max_new <= 256
        assert 0 <= min(r.prompt) and max(r.prompt) < 300
    for j in range(CHAT["initial"]):
        r = t.initial_request(j)
        assert 64 <= len(r.prompt) <= 512 and 1 <= r.max_new <= 256


def test_loguniform_quantiles():
    d = {"dist": "loguniform", "min": 64, "max": 512}
    u = stratified(100000)
    v = quantile(d, u)
    assert v.min() == 64 and v.max() == 512
    # median of a log-uniform over [64, 513) is sqrt(64 * 513)
    assert abs(np.median(v) - math.sqrt(64 * 513)) <= 1
    # the mean of log v is the mean of the log-uniform
    assert abs(np.log(v + 0.5).mean() - (math.log(64) + math.log(513)) / 2) < 0.01


def test_uniform_quantiles():
    d = {"dist": "uniform", "min": 16, "max": 48}
    v = quantile(d, stratified(33))
    assert sorted(v.tolist()) == list(range(16, 49))


def test_residual_is_the_equilibrium_residual():
    d = {"dist": "uniform", "min": 16, "max": 48}
    r = residual_quantile(d, stratified(200000))
    # E[R] = E[L (L + 1)] / (2 E[L]) for the discrete renewal residual
    L = np.arange(16, 49)
    want = (L * (L + 1)).mean() / (2 * L.mean())
    assert abs(r.mean() - want) < 0.05
    assert r.min() == 1 and r.max() == 48
