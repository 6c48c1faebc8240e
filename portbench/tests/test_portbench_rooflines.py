"""Each roofline function against a count made by hand."""

from portbench.lib import common

K1 = common.roofline("k1")
STEP = common.roofline("decode_step")
ENC = common.roofline("codec_encoder")


def test_k1_counts_unmasked_pairs_once():
    # rows of 3 and 2 positions: 6 + 3 = 9 pairs; 2 heads of width 4
    flops, nbytes = K1.ops_bytes([3, 2], heads=2, head_dim=4)
    assert flops == 9 * 2 * (2 * 4 + 2 * 4)
    assert nbytes == (3 + 2) * 2 * 4 * 4 * 2  # q, k, v, o in bf16
    b = K1.bound_s([3, 2], heads=2, head_dim=4, peak_flops=1e3, peak_bytes=1e9)
    assert b == flops / 1e3


def test_decode_step_by_hand():
    cfg = dict(d_model=2, num_layers=1, n_codebooks=1, ffn_mult=4, head_hidden=3,
               tokens=dict(audio_vocab_size=4, n_special=1, max_n_spans=0))
    d, f, hh, card = 2, 8, 3, 5
    flops, nbytes = STEP.ops_bytes(cfg, [3])
    w = 4 * d * d + 2 * d * f  # qkv + out, ffn1 + ffn2
    heads = d * hh + hh * card
    assert flops == 2 * w + 2 * heads + 4 * d * 3
    bias = 3 * d + d + f + d
    assert nbytes == ((w + bias) * 2 + 4 * d * 4 + (heads + hh + card) * 4
                      + d * 4 + 2 * 2 * d * 3 + (2 * 2 * d + card * 4))


def test_codec_encoder_by_hand():
    codec = dict(seanet=dict(channels=1, dimension=2, n_filters=1,
                             n_residual_layers=1, ratios=[2], kernel_size=3,
                             last_kernel_size=3, residual_kernel_size=3,
                             compress=1, lstm=1),
                 rvq=dict(n_q=1, bins=2, dimension=2))
    t = 4
    conv_in = 2 * 3 * 1 * 1 * t
    res = 2 * t * (3 * 1 * 1 + 1 * 1)
    down = 2 * 2 * 4 * 1 * 2  # 2 frames out, kernel 4, 1 -> 2 channels
    lstm = 2 * 2 * 4 * 2 * (2 + 2)
    out = 2 * 2 * 3 * 2 * 2
    rvq = 2 * 2 * 2 * 2
    assert ENC.flops(codec, t) == conv_in + res + down + lstm + out + rvq
