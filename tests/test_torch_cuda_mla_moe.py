"""The MLA + MoE block's hand-written kernels against their plain PyTorch
versions, on the card: K11 (``ops/moe_experts.py``, the routed experts of
a decode step) and K12 (``ops/mla_attention.py``, the paged step's latent
attention), at the shapes of the ``moonlight-serve-open-16lane`` cell
(d 2,048, 64 experts of width 1,408, 6 a token, 32 rows; 16 heads over a
576-wide latent) and with a lane refilled mid-flight; both replayed from a
CUDA graph with their launches counted. Skipped where
torch.cuda.is_available() is false.

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_mla_moe.py
"""

import pytest
import torch

from ssr_speech_tpu_torch.ops import mla_attention as mla
from ssr_speech_tpu_torch.ops import moe_experts as moe

pytestmark = pytest.mark.cuda

D, F, E, K = 2048, 1408, 64, 6
# max |kernel - plain| / max |plain|: both round the products and silu(g) * u
# to bf16 and add in fp32, in different orders, so a rounded value may land
# an ulp apart (2^-8 relative) and carry into the next product
MOE_REL = 1e-2
# against the fp32 attention of the same bf16 inputs: the plain version
# rounds the normalised probabilities to bf16, the kernel exp(s - max), each
# a 2^-9 relative error on a sum of positive terms
MLA_REL = 1e-2


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    from ssr_speech_tpu_torch.device import resolve_device, set_precision_policy

    set_precision_policy()
    return resolve_device("cuda")


def _experts(device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    gu = (torch.rand((E, 2 * F, D), generator=g, device=device) * 2 - 1) * D ** -0.5
    dn = (torch.rand((E, D, F), generator=g, device=device) * 2 - 1) * F ** -0.5
    return gu.bfloat16(), dn.bfloat16()


def _routing(n, device, skew, seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    if skew:  # every row picks among the same eight experts
        idx = torch.stack([torch.randperm(8, generator=g, device=device)[:K]
                           for _ in range(n)])
    else:
        idx = torch.stack([torch.randperm(E, generator=g, device=device)[:K]
                           for _ in range(n)])
    w = torch.rand((n, K), generator=g, device=device)
    return idx, w / w.sum(-1, keepdim=True) * 2.446


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


@pytest.mark.parametrize("n,skew", [(32, False), (2, False), (32, True),
                                    (64, False), (100, False), (200, False),
                                    (200, True)])
def test_moe_experts_matches_plain(device, n, skew):
    """32 rows (16 lanes under CFG) over all experts, 2 rows (the edit
    path's step), and 32 rows crowding eight experts; 64, 100 and 200 rows
    (each n-tile width the launch picks, 1,200 (row, choice) pairs at 200),
    200 crowding eight experts (150 slots an expert: two passes). The
    routing counters against a hand count of the live rows' pairs; a row
    that is not live gets zeros, and none live counts nothing."""
    gu, dn = _experts(device)
    idx, w = _routing(n, device, skew)
    x = torch.randn((n, D), device=device).bfloat16()
    parked = torch.arange(n, device=device) % 3 != 1
    for live in (None, parked, torch.zeros(n, dtype=torch.bool, device=device)):
        counts = torch.zeros((2, E), dtype=torch.int32, device=device)
        got = moe.kernel_moe_experts(x, idx, w, gu, dn, counts=counts, live=live)
        want = moe.plain_moe_experts(x, idx, w, gu, dn, live=live)
        rows = torch.ones(n, dtype=torch.bool, device=device) if live is None else live
        if rows.any():
            assert _rel(got[rows], want[rows]) < MOE_REL
        assert bool((got[~rows] == 0).all())
        hits = torch.bincount(idx[rows].reshape(-1), minlength=E).int()
        assert torch.equal(counts[0], hits)
        assert torch.equal(counts[1], (hits > 0).int())
    again = moe.kernel_moe_experts(x, idx, w, gu, dn)
    assert torch.equal(again, moe.kernel_moe_experts(x, idx, w, gu, dn))


def test_moe_experts_refuses_past_its_tiles(device):
    """A CUDA bf16 step past the kernel's tiles is refused, not sent to the
    plain version: 1,366 rows of 6 choices are 8,196 pairs."""
    gu, dn = _experts(device)
    n = 1366
    idx = torch.zeros((n, K), dtype=torch.int64, device=device)
    w = torch.ones((n, K), device=device)
    x = torch.zeros((n, D), device=device).bfloat16()
    with pytest.raises(ValueError, match="8192"):
        moe.moe_experts(x, idx, w, gu, dn)


def _latents(device, B=32, tp=1344, tg=640, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    pfx = torch.randn((B, tp, 576), generator=g, device=device).bfloat16()
    gen = torch.randn((B, tg, 576), generator=g, device=device).bfloat16()
    cur = torch.randn((B, 576), generator=g, device=device).bfloat16()
    q = torch.randn((B, 16, 576), generator=g, device=device).bfloat16()
    banned = torch.zeros((B, tp), dtype=torch.bool, device=device)
    banned[:, 150:192] = True  # text padding
    banned[B // 2:, 1:192] = True  # the uncond rows see one text token
    banned[:, 700:] = True  # the prompt's padded tail
    banned[3, :] = False
    gen_len = torch.randint(0, tg, (B,), generator=g, device=device)
    gen_len[0], gen_len[1], gen_len[2] = 0, tg, 1  # refilled, full, one
    return q, cur, pfx, gen, banned, gen_len


def _fp32_attention(q, cur, pfx, gen, banned, gen_len, tp, rl, scale):
    return mla.plain_paged_mla_attention(
        q.float(), cur.float(), pfx.float(), gen.float(), banned, gen_len, tp,
        rl, scale, 512)


@pytest.mark.parametrize("rl", [640, 128])
def test_mla_attention_matches_plain(device, rl):
    q, cur, pfx, gen, banned, gen_len = _latents(device)
    gen_len = gen_len.clamp(max=rl)
    tp, scale = pfx.shape[1], 192 ** -0.5
    got = mla.kernel_paged_mla_attention(q, cur, pfx, gen, banned, gen_len, tp,
                                         rl, scale, 512)
    plain = mla.plain_paged_mla_attention(q, cur, pfx, gen, banned, gen_len, tp,
                                          rl, scale, 512)
    exact = _fp32_attention(q, cur, pfx, gen, banned, gen_len, tp, rl, scale)
    for b in range(q.shape[0]):
        assert _rel(got[b], exact[b]) < MLA_REL, b
        assert _rel(plain[b], exact[b]) < MLA_REL, b
    assert torch.equal(got, mla.kernel_paged_mla_attention(
        q, cur, pfx, gen, banned, gen_len, tp, rl, scale, 512))


def test_mla_attention_ignores_dead_keys(device):
    """A refilled lane's generated columns and the banned prompt keys are
    not read: garbage there (inf and nan) changes nothing."""
    q, cur, pfx, gen, banned, gen_len = _latents(device, B=4, tp=256, tg=128)
    tp, scale = 256, 192 ** -0.5
    want = mla.kernel_paged_mla_attention(q, cur, pfx, gen, banned, gen_len, tp,
                                          128, scale, 512)
    pfx2, gen2 = pfx.clone(), gen.clone()
    pfx2[banned] = float("nan")
    for b in range(4):
        gen2[b, int(gen_len[b]):] = float("inf")
    got = mla.kernel_paged_mla_attention(q, cur, pfx2, gen2, banned, gen_len, tp,
                                         128, scale, 512)
    assert torch.equal(got, want)


def test_kernels_count_replayed_launches(device):
    """A graph capturing one call of each records its launches (three for
    K11, one for K12) and every replay adds them to the counters."""
    from ssr_speech_tpu_torch.inference.graphs import GraphProgram

    gu, dn = _experts(device)
    idx, w = _routing(32, device, False)
    x = torch.randn((32, D), device=device).bfloat16()
    q, cur, pfx, gen, banned, gen_len = _latents(device, B=8, tp=256, tg=128)
    out = {}

    def fn():
        out["moe"] = moe.moe_experts(x, idx, w, gu, dn)
        out["mla"] = mla.paged_mla_attention(q, cur, pfx, gen, banned, gen_len,
                                             256, 128, 192 ** -0.5, 512)

    prog = GraphProgram(device, True)
    prog.run(fn)  # warm-up and capture
    moe.reset_launches()
    mla.reset_launches()
    for _ in range(3):
        prog.run(fn)
    torch.cuda.synchronize()
    assert (moe.launches, mla.launches) == (3 * moe.LAUNCHES_PER_CALL, 3)
    assert _rel(out["moe"], moe.plain_moe_experts(x, idx, w, gu, dn)) < MOE_REL
