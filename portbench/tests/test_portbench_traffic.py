"""The traffic generator: the same seed gives the same inputs, every seed
the same set of sizes in another order."""

import numpy as np
import torch

from portbench.lib import common, traffic

CFG = common.config("ssr-e830m")
EDIT = common.traffic_params("edit-1client")
WAVES = common.traffic_params("prep-encode")
SEED = 2 ** 31 + 977


def _edit(seed, n=40):
    sizes = traffic.edit_sizes(EDIT, seed, n)
    return sizes, [traffic.edit_request(EDIT, CFG, seed, i, s)
                   for i, s in enumerate(sizes[:6])]


def test_edit_same_seed_same_inputs():
    (s1, r1), (s2, r2) = _edit(SEED), _edit(SEED)
    assert s1 == s2
    for a, b in zip(r1, r2):
        assert a["span"] == b["span"] and a["greedy"] == b["greedy"]
        for key in ("x", "y", "wav"):
            np.testing.assert_array_equal(a[key], b[key])


def test_edit_other_seed_same_sizes_other_order():
    n = len(EDIT["block"]) * 3
    a, _ = _edit(SEED, n)
    b, _ = _edit(SEED + 1, n)
    key = lambda s: (s["frames"], s["span"], s["greedy"])
    assert sorted(map(key, a)) == sorted(map(key, b))
    assert list(map(key, a)) != list(map(key, b))


def test_edit_length_cap_ends_each_span_at_its_length():
    K = CFG["n_codebooks"]
    for t, span, _ in EDIT["block"]:
        req = traffic.edit_request(EDIT, CFG, SEED, 0, dict(frames=t, span=span,
                                                            greedy=False))
        from portbench.reference import patterns
        prefix, _, _ = patterns.inference_prefix(req["y"], [req["span"]],
                                                 CFG["tokens"])
        cap = len(req["x"]) * EDIT["length_cap_mult"]
        assert cap - prefix.shape[1] == span  # frames generated
        assert 40 <= len(req["x"]) <= 150
        assert span + K < EDIT["max_gen_per_span"]
        assert req["wav"].shape == (1, t * 320, 1)


def test_waves_same_seed_same_pool_and_batches():
    p1 = traffic.wave_pool(WAVES, SEED, 320, 16000, torch.device("cpu"))
    p2 = traffic.wave_pool(WAVES, SEED, 320, 16000, torch.device("cpu"))
    assert all(np.array_equal(a, b) for a, b in zip(p1, p2))
    b1 = traffic.wave_batches(WAVES, p1, 320, SEED)
    b2 = traffic.wave_batches(WAVES, p2, 320, SEED)
    assert [b["idx"] for b in b1] == [b["idx"] for b in b2]
    total = sum(len(w) for w in p1) * 4
    assert 90e6 < total < 120e6  # a pool of about 100 MB


def test_waves_every_seed_same_shapes():
    shapes = []
    for seed in (SEED, SEED + 5):
        pool = traffic.wave_pool(WAVES, seed, 320, 16000, torch.device("cpu"))
        batches = traffic.wave_batches(WAVES, pool, 320, seed)
        assert all(len(b["idx"]) <= WAVES["batch"] for b in batches)
        assert all(max(b["frames"]) <= b["pad"] for b in batches)
        shapes.append(sorted((len(b["idx"]), b["pad"], sum(b["frames"]))
                             for b in batches))
        wav = traffic.padded(pool, batches[0], 320)
        assert wav.shape == (len(batches[0]["idx"]), batches[0]["pad"] * 320, 1)
    assert shapes[0] == shapes[1]


def test_waves_padded_into_a_used_buffer_as_into_a_new_one():
    pool = traffic.wave_pool(WAVES, SEED, 320, 16000, torch.device("cpu"))
    batches = traffic.wave_batches(WAVES, pool, 320, SEED)
    slot = np.full(max(len(b["idx"]) * b["pad"] * 320 for b in batches),
                   7.0, np.float32)  # a pinned slot's last batch left behind
    for b in batches[:4]:
        n = len(b["idx"]) * b["pad"] * 320
        got = traffic.padded(pool, b, 320, out=slot[:n])
        np.testing.assert_array_equal(got, traffic.padded(pool, b, 320))
        assert np.shares_memory(got, slot)


SERVE = common.traffic_params("serve-open")


def test_serve_same_seed_same_inputs_and_arrivals():
    a = traffic.serve_requests(SERVE, CFG, SEED, 40)
    b = traffic.serve_requests(SERVE, CFG, SEED, 40)
    for u, v in zip(a, b):
        assert u["kind"] == v["kind"] and u["span"] == v["span"]
        np.testing.assert_array_equal(u["x"], v["x"])
        np.testing.assert_array_equal(u["y"], v["y"])
    np.testing.assert_array_equal(traffic.arrivals(5.0, 40, SEED),
                                  traffic.arrivals(5.0, 40, SEED))


def test_serve_other_seed_same_gaps_and_sizes():
    n = 2 * (len(SERVE["edit_block"]) + len(SERVE["tts_block"]))
    t1, t2 = traffic.arrivals(5.0, n, SEED), traffic.arrivals(5.0, n, SEED + 3)
    np.testing.assert_allclose(np.sort(np.diff(t1, prepend=0)),
                               np.sort(np.diff(t2, prepend=0)))
    assert not np.allclose(t1, t2)
    key = lambda r: (r["kind"], r["frames"], r["span"][1] - r["span"][0], r["gen"])
    a = sorted(map(key, traffic.serve_requests(SERVE, CFG, SEED, n)))
    b = sorted(map(key, traffic.serve_requests(SERVE, CFG, SEED + 3, n)))
    assert a == b


def test_serve_length_cap_ends_each_span_at_its_length():
    from portbench.reference import patterns
    for r in traffic.serve_requests(SERVE, CFG, SEED, 32):
        prefix, _, _ = patterns.inference_prefix(r["y"], [r["span"]], CFG["tokens"])
        assert len(r["x"]) * SERVE["length_cap_mult"] - prefix.shape[1] == r["gen"]
        assert r["gen"] + CFG["n_codebooks"] < SERVE["max_gen_per_span"]
