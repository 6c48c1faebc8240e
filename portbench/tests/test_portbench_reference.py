"""The plain reference against the port at a tiny geometry on the CPU, on
the same seeded weights: the LM's logits over a whole sequence, the codec's
encoder and RVQ, and its watermark decode."""

import numpy as np
import torch

from portbench.lib import port, weights
from portbench.reference import codec as codec_ref
from portbench.reference import lm as lm_ref
from portbench.tests import tiny

CPU = torch.device("cpu")


def test_lm_logits_match_the_port():
    from ssr_speech_tpu_torch.models import ssr
    from ssr_speech_tpu_torch.models import transformer as trf

    cfg = tiny.tiny_lm()
    mcfg = port.lm_config(cfg)
    lm = port.lm(cfg, 11, CPU)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 119, size=9)
    y = rng.integers(0, 64, size=(4, 13))
    xt, yt = torch.as_tensor(x)[None], torch.as_tensor(y.T)[None]
    with torch.no_grad():
        h = ssr.ssr_embed(lm, mcfg, dict(x=xt, y=yt))
        n = h.shape[1]
        bias = torch.triu(torch.full((n, n), -1e9), 1)[None, None]
        out = trf.transformer_forward(lm["decoder"], h, mcfg, bias=bias)
        want = ssr.predict_logits(lm, out[:, len(x):])[0]
    ref = lm_ref.LM(weights.lm_weights(cfg, 11, CPU, torch.float32), cfg,
                    torch.float32)
    got = ref.logits(x, y, 13)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_codec_encode_and_wmdecode_match_the_port():
    from ssr_speech_tpu_torch.models.codec import wmencodec as wm

    codec = tiny.tiny_codec(tiny.common.config("wmencodec-nq4-s320"))
    params, ccfg = port.codec(codec, 5, CPU)
    C = weights.codec_weights(codec, 5, CPU)
    wav = torch.randn(2, 40 * 320, 1, generator=torch.Generator().manual_seed(1)) * 0.1
    codes, _, emb = wm.encode(params, wav, ccfg)
    z = codec_ref.encode(C["encoder"], wav, codec["seanet"])
    torch.testing.assert_close(z, emb, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(
        codec_ref.quantize(C["quantizer"]["embed"], z, 4), codes)
    labels = torch.zeros(2, 40, dtype=torch.long)
    labels[:, 10:25] = 1
    out, mark = wm.wmdecode(params, codes, labels, wav, ccfg)
    ref, ref_mark = codec_ref.wm_decode(
        C["wmdecoder"], codec_ref.dequantize(C["quantizer"]["embed"], codes),
        labels, wav, codec["seanet"])
    torch.testing.assert_close(ref, out, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ref_mark, mark, rtol=1e-4, atol=1e-5)


def test_lm_bf16_rounds_where_the_configuration_says():
    """At bfloat16 the reference differs from float32 by rounding only: the
    same logits to bf16's few digits, and its fp8 control further off."""
    cfg = tiny.tiny_lm()
    W = weights.lm_weights(cfg, 11, CPU, torch.float32)
    rng = np.random.default_rng(1)
    x, y = rng.integers(0, 119, size=7), rng.integers(0, 64, size=(4, 11))
    f32 = lm_ref.LM(W, cfg, torch.float32).logits(x, y, 11)
    b16 = lm_ref.LM(W, cfg, torch.bfloat16).logits(x, y, 11)
    f8 = lm_ref.LM(W, cfg, torch.bfloat16, fp8=True).logits(x, y, 11)
    e16, e8 = (b16 - f32).abs().max(), (f8 - f32).abs().max()
    assert 0 < e16 < 0.05 and e8 > 2 * e16
