"""The port's benchmark (``ssr_speech_tpu_torch/bench.py``) on the CPU.

At a tiny geometry (``tiny_ssr_config``, the tiny codec of
tests/test_torch_cli.py, fewer seconds) the four requests of the JAX
benchmark run greedy in fp32 through the port's ``run_bench`` and through
JAX's ``decode.generate`` / ``generate_batch``, from the same parameters with
the EOG bias set in both: codes, marks and intervals identical, and the frame
counts that enter each RTF equal. Then the entry point's JSON line: every key
of the root ``bench.py``'s line, positive finite RTFs, ``codec_mae`` null.
"""

import ast
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ssr_speech_tpu.config import (CodecConfig, RVQConfig, SEANetConfig,
                                   tiny_ssr_config)
from ssr_speech_tpu.inference import decode as jdecode
from ssr_speech_tpu.models import ssr as jssr
from ssr_speech_tpu.models.codec import wmencodec as jwm
from ssr_speech_tpu_torch import bench as tbench
from ssr_speech_tpu_torch.data.tokenizer import AudioTokenizer
from ssr_speech_tpu_torch.models.from_jax import codec_from_jax, lm_from_jax
from tests.test_torch_hostcopies import jax_config, port_config

REPO = Path(__file__).resolve().parent.parent
CFG = tiny_ssr_config(text_vocab_size=40)
CODEC = CodecConfig(
    seanet=SEANetConfig(dimension=16, n_filters=2, n_residual_layers=1,
                        ratios=(8, 5, 4, 2), lstm=1, norm="weight_norm",
                        pad_mode="constant"),
    rvq=RVQConfig(dimension=16, n_q=CFG.n_codebooks,
                  bins=CFG.tokens.audio_vocab_size))
TCFG, TCODEC = port_config(CFG), port_config(CODEC)
# bench.py's shapes cut to the tiny LM: 0.4 s of TTS after a 15-frame prompt,
# a 20-frame span of a 40-frame utterance, 3 chains
SIZES = tbench.Sizes(tts_seconds=0.4, sx=12, prompt_frames=15, utt_frames=40,
                     span=(15, 35), zh_sx=8, n_samples=3, tmax=256, n_runs=1)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def greedy():
    """(JAX params with the EOG bias, the port's run_bench report on the
    same weights, greedy)."""
    params = jssr.init_ssr(jax.random.PRNGKey(0), CFG)
    params["head2_b"] = params["head2_b"].at[:, CFG.tokens.eog].set(-1e9)
    params = jax.tree.map(np.asarray, params)
    codec = AudioTokenizer(codec_from_jax(jax.tree.map(
        np.asarray, jwm.init_wmencodec(jax.random.PRNGKey(1), CODEC)), TCODEC),
        TCODEC)
    lines = []
    _, report = tbench.run_bench(TCFG, TCODEC, CPU, SIZES,
                                 models=(lm_from_jax(params, TCFG), codec),
                                 log=lines.append, top_k=1)
    assert len(lines) == len(tbench.REQUESTS) * (SIZES.n_runs + 1)
    return params, report


def _jax_results(params, name):
    inputs = tbench.bench_inputs(TCFG, TCODEC, SIZES)
    decs = tbench.decode_configs(TCFG, SIZES, inputs["frames"], top_k=1)
    key = jax.random.PRNGKey(0)
    if name == "tts":
        return [jdecode.generate(params, CFG, jax_config(decs["tts"]),
                                 inputs["x"], inputs["y"], inputs["tts_mask"],
                                 key, dtype_name="float32")]
    if name == "batch":
        return jdecode.generate_batch(
            params, CFG, jax_config(decs["tts"]), inputs["x"], inputs["y"],
            inputs["tts_mask"], key, n_samples=SIZES.n_samples,
            tmax=SIZES.tmax, dtype_name="float32")
    x = inputs["x"] if name == "edit" else inputs["x_zh"]
    return [jdecode.generate(params, CFG, jax_config(decs[name]), x,
                             inputs["y_edit"], [SIZES.span], key,
                             dtype_name="float32")]


@pytest.mark.parametrize("name", tbench.REQUESTS)
def test_bench_requests_match_jax_greedy(greedy, name):
    params, report = greedy
    got = report[name]["last"].results
    want = _jax_results(params, name)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2] == w[2] and g[3] == w[3]
    # the frames that enter the RTF, by the JAX benchmark's arithmetic
    pf = SIZES.prompt_frames
    if name == "tts":
        frames = want[0][0].shape[2] - pf
        assert frames == int(SIZES.tts_seconds * TCODEC.frame_rate)
    elif name == "batch":
        frames = sum(w[0].shape[2] - pf for w in want)
        assert frames == SIZES.n_samples * report["tts"]["frames"][0]
    else:
        frames = int(np.asarray(want[0][1]).sum())
        assert frames == SIZES.span[1] - SIZES.span[0]
    assert report[name]["frames"] == [frames] * (SIZES.n_runs + 1)
    wav = report[name]["last"].wav
    if name != "batch":  # finite, at the codes' length
        assert np.isfinite(wav).all()
        assert wav.shape[1] == got[0][0].shape[2] * TCODEC.hop_length


def _bench_py_keys():
    """The keys of the root bench.py's JSON line (the dict bound to ``line``
    in its ``main``, and the note it adds)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "line" for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Subscript) and getattr(node.value, "id", None) \
                == "line" and isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
    return keys


def test_bench_main_prints_the_benchmark_line(monkeypatch, capsys):
    """``main(["--device", "cpu"])`` with the geometry cut to the tiny one:
    a line a run, then the JSON line with bench.py's keys and ``device``."""
    monkeypatch.setattr(tbench, "e830m_config", lambda: TCFG)
    monkeypatch.setattr(tbench, "CodecConfig", lambda: TCODEC)
    monkeypatch.setattr(tbench, "Sizes", lambda: SIZES)
    line = tbench.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[-1]) == line
    assert sum(o.startswith("[bench] ") for o in out) == 4 * (SIZES.n_runs + 1)
    keys = _bench_py_keys()
    assert {"value", "edit_rtf", "zh_edit_rtf", "aggregate_rtf_s8",
            "codec_mae", "codec_mae_note"} <= keys
    assert keys | {"device"} == set(line)
    for key in ("value", "edit_rtf", "zh_edit_rtf", "aggregate_rtf_s8"):
        assert math.isfinite(line[key]) and line[key] > 0, (key, line[key])
    assert line["codec_mae"] is None
    assert line["codec_mae_note"] == "reference tree not mounted"
    assert line["device"] == "cpu"
