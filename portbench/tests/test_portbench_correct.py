"""A whole run at a tiny geometry on the CPU, past the harness's look for a
card: ``correct`` holds on the port as it is, and comes out false with the
timed path broken underneath, for each fault a cell can have: a token or
an answer altered where it is produced (a sampled token, the splice's
codes, the codec's waveform, a code), a step that leaves its state (the
K/V cache) unchanged, half of a batch left out (an encode batch's rows,
the server's lanes). The cells run on one chip: no exchange to leave out.
The control (the reference with fp8 products) put in the program's place
comes out not correct, its number above the program's. The codec's
control (TF32) changes nothing on a CPU: it is held on the card
(``test_portbench_dryrun``)."""

import torch

from portbench.tests import tiny


def _correct(ctx):
    out, _, _ = tiny.measure(ctx)
    return all(c["ok"] for c in out.checks), out


def _check(out, name):
    return next(c for c in out.checks if c["name"] == name)


def test_edit_run_is_correct_and_control_reads_higher():
    ok, out = _correct(tiny.edit_context())
    assert ok, out.checks
    ok_c, ctrl = _correct(tiny.edit_context(control=True))
    assert not ok_c
    gap, low = _check(out, "logit_gap_mean"), _check(ctrl, "logit_gap_mean")
    assert not low["ok"] and low["value"] > 3 * max(gap["value"], 1e-6)


def test_edit_altered_token_is_caught(monkeypatch):
    from ssr_speech_tpu_torch.inference import decode

    real = decode.categorical

    def shifted(generator, logits):  # the second choice, not the first
        s = real(generator, logits)
        return torch.where(s < 60, (s + 1) % 64, s)

    monkeypatch.setattr(decode, "categorical", shifted)
    ok, out = _correct(tiny.edit_context())
    assert not ok
    assert not next(c for c in out.checks if c["name"] == "logit_gap_mean")["ok"]


def test_edit_altered_waveform_is_caught(monkeypatch):
    from ssr_speech_tpu_torch.models.codec import wmencodec as wm

    real = wm.wmdecode

    def louder(*a, **k):
        wav, mark = real(*a, **k)
        return wav * 1.01, mark

    monkeypatch.setattr(wm, "wmdecode", louder)
    ok, out = _correct(tiny.edit_context())
    assert not ok
    assert not next(c for c in out.checks if c["name"] == "wav_rel_err")["ok"]


def test_edit_altered_splice_is_caught(monkeypatch):
    from ssr_speech_tpu_torch.ops import patterns

    real = patterns.splice_generated

    def shifted(*a, **k):
        codes, marks, iv = real(*a, **k)
        codes = codes.copy()
        codes[0, 0, 0] = (codes[0, 0, 0] + 1) % 64
        return codes, marks, iv

    monkeypatch.setattr(patterns, "splice_generated", shifted)
    ok, out = _correct(tiny.edit_context())
    assert not next(c for c in out.checks if c["name"] == "codes_mismatch")["ok"]


def test_encode_run_is_correct():
    ok, out = _correct(tiny.encode_context())
    assert ok, out.checks


def test_encode_altered_code_is_caught(monkeypatch):
    from ssr_speech_tpu_torch.models.codec import quantize

    real = quantize.nearest_code

    def second(codebook, x):
        idx = real(codebook, x)
        return (idx + 1) % codebook.shape[0]

    monkeypatch.setattr(quantize, "nearest_code", second)
    ok, out = _correct(tiny.encode_context())
    assert not ok


def test_encode_half_batch_lost_is_caught(monkeypatch):
    from ssr_speech_tpu_torch.models.codec import wmencodec as wm

    real = wm.encode

    def half(params, wav, cfg):
        codes, scale, emb = real(params, wav[: max(1, wav.shape[0] // 2)], cfg)
        full = torch.zeros((wav.shape[0],) + codes.shape[1:], dtype=codes.dtype)
        full[: codes.shape[0]] = codes
        lat = torch.zeros((wav.shape[0],) + emb.shape[1:], dtype=emb.dtype)
        lat[: emb.shape[0]] = emb
        return full, scale, lat

    monkeypatch.setattr(wm, "encode", half)
    ok, out = _correct(tiny.encode_context())
    assert not ok


def test_serve_run_is_correct():
    ok, out = _correct(tiny.serve_context())
    assert ok, out.checks
    assert out.e2e["latency_p95_s"] > 0


def test_serve_control_is_not_correct():
    # at this size the fp8 control flips a token on some seeds only (the
    # program reads 0 there: fp32 against fp32 on a CPU); this is one
    ok, out = _correct(tiny.serve_context(seed=12, control=True))
    assert not ok
    assert not _check(out, "logit_gap_mean")["ok"]


def test_serve_altered_token_is_caught(monkeypatch):
    from ssr_speech_tpu_torch.inference import decode

    real = decode.categorical

    def shifted(generator, logits):
        s = real(generator, logits)
        return torch.where(s < 60, (s + 1) % 64, s)

    monkeypatch.setattr(decode, "categorical", shifted)
    ok, out = _correct(tiny.serve_context())
    assert not next(c for c in out.checks if c["name"] == "logit_gap_mean")["ok"]


def test_edit_step_that_leaves_the_cache_unchanged_is_caught(monkeypatch):
    from ssr_speech_tpu_torch.models import transformer as trf

    monkeypatch.setattr(trf, "_write_at", lambda buf, pos, new: None)
    ok, out = _correct(tiny.edit_context())
    assert not next(c for c in out.checks if c["name"] == "logit_gap_mean")["ok"]


def test_serve_half_the_rows_left_out_is_caught(monkeypatch):
    from ssr_speech_tpu_torch.inference import serve
    from ssr_speech_tpu_torch.models import ssr

    real = ssr.predict_logits

    def half(params, h, dtype=torch.float32):  # the second half of the lanes
        logits = real(params, h, dtype)
        lanes = logits.shape[0] // 2  # [cond rows ; uncond rows]
        lane = torch.arange(logits.shape[0], device=logits.device) % lanes
        keep = lane < lanes // 2
        return torch.where(keep[:, None, None], logits, torch.zeros_like(logits))

    monkeypatch.setattr(serve.ssr_model, "predict_logits", half)
    ok, out = _correct(tiny.serve_context(rate=30.0, seconds=1.0))  # lanes busy
    assert not ok
