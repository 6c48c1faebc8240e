"""The port's discriminators against ``ssr_speech_tpu.training.
discriminators`` on the CPU in fp32: MS-STFT, MSD and MPD logits and every
feature map within 1e-5 relative (to the largest element of each tensor),
from weights drawn by JAX's init and carried across by ``conv_from_jax``.
The port's NCHW (NCW) outputs are moved to JAX's NHWC (NWC) to compare."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssr_speech_tpu.training import discriminators as jd
from ssr_speech_tpu_torch.training import discriminators as td
from ssr_speech_tpu_torch.utils import prng
from ssr_speech_tpu_torch.utils.tree import tree_leaves

REL = 1e-5


def _wav(t, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, t, 1)) * 0.1).astype(np.float32)


def _to_jax_layout(t: torch.Tensor) -> np.ndarray:
    """NCHW -> NHWC, NCW -> NWC."""
    return t.detach().float().movedim(1, -1).numpy()


def _compare(got, want):
    glog, gfm = got
    wlog, wfm = want
    assert len(glog) == len(wlog) and len(gfm) == len(wfm)
    for g, w in zip(glog, wlog):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(_to_jax_layout(g), w, rtol=0,
                                   atol=REL * np.abs(w).max())
    for gs, ws in zip(gfm, wfm):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            w = np.asarray(w, np.float32)
            np.testing.assert_allclose(_to_jax_layout(g), w, rtol=0,
                                       atol=REL * np.abs(w).max())


@pytest.mark.parametrize("filters,n_scales,t", [(4, 5, 4096), (32, 2, 2560)])
def test_msstftd_matches(filters, n_scales, t):
    params = jd.init_msstftd(jax.random.PRNGKey(0), filters=filters,
                             n_scales=n_scales)
    wav = _wav(t, 1)
    want = jd.msstftd_forward(params, jnp.asarray(wav))
    got = td.msstftd_forward(td.conv_from_jax(params), torch.from_numpy(wav))
    assert len(got[0]) == n_scales
    _compare(got, want)


def test_msd_matches():
    params = jd.init_msd(jax.random.PRNGKey(1))
    wav = _wav(3203, 2)  # odd length: the pooled scales round
    want = jd.msd_forward(params, jnp.asarray(wav))
    got = td.msd_forward(td.conv_from_jax(params), torch.from_numpy(wav))
    assert len(got[0]) == 3 and len(got[1][0]) == 7
    _compare(got, want)


def test_mpd_matches():
    params = jd.init_mpd(jax.random.PRNGKey(2))
    wav = _wav(3001, 3)  # no multiple of any period: reflect padding
    want = jd.mpd_forward(params, jnp.asarray(wav))
    got = td.mpd_forward(td.conv_from_jax(params), torch.from_numpy(wav))
    assert len(got[0]) == 5 and len(got[1][0]) == 6
    _compare(got, want)


@pytest.mark.parametrize("name,kw", [("msstftd", dict(filters=4)),
                                     ("msd", {}), ("mpd", {})])
def test_port_init_has_the_jax_structure_and_round_trips(name, kw):
    """The port's own init from the same threefry seed gives the JAX init's
    tree in the port's layout: the same leaves after ``conv_to_jax`` (v and
    b bit for bit, g = ||v|| per output channel within 1e-6 relative: the
    sum's order is the backend's), and a round trip bit for bit."""
    jparams, _ = jd.get_adversary(name, jax.random.PRNGKey(0), **kw)
    tparams, fwd = td.get_adversary(name, prng.PRNGKey(0), **kw)
    assert fwd is getattr(td, f"{name}_forward")
    back = td.conv_to_jax(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jparams))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree.leaves(jparams)):
        b = np.asarray(b)
        assert a.shape == b.shape
        if path[-1].key == "g":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(a, b)
    first = tparams["subs"][0]["convs"][0]
    norm = first["v"].square().sum(dim=tuple(range(1, first["v"].dim())),
                                   keepdim=True).sqrt()
    torch.testing.assert_close(first["g"], norm)
    again = td.conv_to_jax(td.conv_from_jax(back))
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        td.get_adversary("nope", prng.PRNGKey(0))


def test_bf16_activations_follow_the_input():
    params = td.init_msstftd(prng.PRNGKey(0), filters=4, n_scales=2)
    wav = torch.from_numpy(_wav(2560, 4)).to(torch.bfloat16)
    logits, fmaps = td.msstftd_forward(params, wav)
    assert all(lg.dtype == torch.bfloat16 for lg in logits)
    assert all(t.dtype == torch.bfloat16 for fm in fmaps for t in fm)
    assert all(p.dtype == torch.float32 for p in tree_leaves(params))
