"""The port's own host modules: cut loose from the JAX package, and in step
with it.

``ssr_speech_tpu_torch`` imports nothing of ``ssr_speech_tpu`` (and no JAX):
it keeps its own copy of the host modules it needs (config, token patterns,
edit spans, the static request scheduler, audio and text helpers,
checkpoints, the dataset, the batcher, the prefetcher, the native helper,
the codec trainer's audio dataset, sample manager, ViSQOL hook and
watermark-span sampler).
Three guards:

(a) a fresh interpreter imports every module of the port, ``chip_smoke`` and
    ``tools/torch_profile_generate`` and ends with neither package loaded;
(b) a scan of the same sources finds no import of the JAX package;
(c) one drift guard per copied module: the same seeded inputs through the
    JAX package's module and the port's copy give the same outputs.

:func:`port_config` is what the parity tests use to hand the port its own
config classes instead of the reference's.
"""

import dataclasses
import importlib
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ssr_speech_tpu import config as jconfig
from ssr_speech_tpu.data import prep as jprep
from ssr_speech_tpu.data import tokenizer as jtokenizer
from ssr_speech_tpu.models import convert as jconvert
from ssr_speech_tpu.utils import asr as jasr
from ssr_speech_tpu.utils import forced_align as jforced_align
from ssr_speech_tpu.utils import quality as jquality
from ssr_speech_tpu import native as jnative
from ssr_speech_tpu.data import audio_dataset as jaudio_dataset
from ssr_speech_tpu.data import batching as jbatching
from ssr_speech_tpu.data import dataset as jdataset
from ssr_speech_tpu.data import prefetch as jprefetch
from ssr_speech_tpu.inference import edit as jedit
from ssr_speech_tpu.inference import serve as jserve
from ssr_speech_tpu.models.codec import wmencodec as jwm
from ssr_speech_tpu.ops import patterns as jpatterns
from ssr_speech_tpu.utils import audio as jaudio
from ssr_speech_tpu.utils import checkpoint as jckpt
from ssr_speech_tpu.utils import sample_manager as jsamples
from ssr_speech_tpu.utils import text_norm as jtext
from ssr_speech_tpu.utils import visqol as jvisqol
from ssr_speech_tpu.utils import watchdog as jwatchdog
from ssr_speech_tpu_torch import config as tconfig
from ssr_speech_tpu_torch.data import prep as tprep
from ssr_speech_tpu_torch.data import tokenizer as ttokenizer
from ssr_speech_tpu_torch.models import convert as tconvert
from ssr_speech_tpu_torch.utils import asr as tasr
from ssr_speech_tpu_torch.utils import forced_align as tforced_align
from ssr_speech_tpu_torch.utils import quality as tquality
from ssr_speech_tpu_torch import native as tnative
from ssr_speech_tpu_torch.data import audio_dataset as taudio_dataset
from ssr_speech_tpu_torch.data import batching as tbatching
from ssr_speech_tpu_torch.data import dataset as tdataset
from ssr_speech_tpu_torch.data import prefetch as tprefetch
from ssr_speech_tpu_torch.inference import edit as tedit
from ssr_speech_tpu_torch.inference import serve as tserve
from ssr_speech_tpu_torch.models.codec import wmencodec as twm
from ssr_speech_tpu_torch.ops import patterns as tpatterns
from ssr_speech_tpu_torch.utils import audio as taudio
from ssr_speech_tpu_torch.utils import checkpoint as tckpt
from ssr_speech_tpu_torch.utils import sample_manager as tsamples
from ssr_speech_tpu_torch.utils import text_norm as ttext
from ssr_speech_tpu_torch.utils import visqol as tvisqol
from ssr_speech_tpu_torch.utils import watchdog as twatchdog

REPO = Path(__file__).resolve().parent.parent
CONFIG_CLASSES = ("TokenSpace", "SSRModelConfig", "MaskingConfig", "DataConfig",
                  "OptimConfig", "TrainConfig", "SEANetConfig", "RVQConfig",
                  "CodecConfig", "DecodeConfig")


def port_config(cfg):
    """The port's config object with the values of a JAX-package config:
    through JSON, as a bundle carries it (the configs nest, so the port's
    ``_from_dict`` rebuilds the inner dataclasses)."""
    text = jconfig.config_to_json(cfg)
    name = type(cfg).__name__
    if name == "SSRModelConfig":
        return tconfig.ssr_config_from_json(text)
    if name == "CodecConfig":
        return tconfig.codec_config_from_json(text)
    return tconfig._from_dict(getattr(tconfig, name), json.loads(text))


def jax_config(cfg):
    """The inverse: the JAX package's config object with the values of one
    of the port's."""
    text = tconfig.config_to_json(cfg)
    return jconfig._from_dict(getattr(jconfig, type(cfg).__name__),
                              json.loads(text))


# ------------------------------------------------- (a) a fresh interpreter

NO_JAX_PACKAGE = (
    "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
    "or m == 'ssr_speech_tpu' or m.startswith('ssr_speech_tpu.')); "
    "assert not bad, bad[:8]")


def port_modules():
    """Every Python module under the port's tree (by source file: the native
    helper's built ``.so`` beside its source is no module)."""
    names = []
    for path in sorted((REPO / "ssr_speech_tpu_torch").rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return names


# the lifecycle modules (checkpoint conversion, aligners, data prep,
# activation checkpointing, the library modules): each is imported below
LIFECYCLE_MODULES = {
    "ssr_speech_tpu_torch." + m for m in (
        "models.convert", "models.pretrained", "utils.forced_align",
        "utils.asr", "inference.cli", "inference.serve_cli", "data.prep",
        "training.optim_extras", "models.transformer", "training.trainer",
        "train_lm", "utils.profiler", "utils.logging_utils", "utils.quality",
        "models.codec.external", "train_codec")}


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = port_modules()
    assert len(mods) > 40 and "ssr_speech_tpu_torch.int8_probe" in mods
    assert {"ssr_speech_tpu_torch.train_codec",
            "ssr_speech_tpu_torch.inference.detect_cli"} <= set(mods)
    assert LIFECYCLE_MODULES <= set(mods)
    code = ("import importlib, sys; sys.path.insert(0, 'tools'); "
            f"[importlib.import_module(m) for m in {mods!r}]; "
            "import chip_smoke, torch_profile_generate; " + NO_JAX_PACKAGE)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


# --------------------------------------------------------- (b) source scan

IMPORT_OF_JAX_PACKAGE = re.compile(
    r"^\s*(from|import)\s+(ssr_speech_tpu|jax)(\.|\s|$)", re.M)


def scanned_sources():
    files = sorted((REPO / "ssr_speech_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tools" / "torch_profile_generate.py",
              REPO / "tests" / "test_torch_cuda.py"]
    return files


@pytest.mark.parametrize("path", scanned_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    hits = [m.group(0).strip() for m in
            IMPORT_OF_JAX_PACKAGE.finditer(path.read_text())]
    assert not hits, hits


def test_scan_pattern_sees_what_it_should():
    bad = ("from ssr_speech_tpu.config import X", "import ssr_speech_tpu",
           "    from ssr_speech_tpu import native", "import jax.numpy as jnp",
           "import ssr_speech_tpu.utils.audio as a")
    good = ("from ssr_speech_tpu_torch.config import X",
            "import ssr_speech_tpu_torch", "from ..config import X",
            "# ``ssr_speech_tpu/config.py``", "from .from_jax import lm_from_jax")
    assert all(IMPORT_OF_JAX_PACKAGE.search(s) for s in bad)
    assert not any(IMPORT_OF_JAX_PACKAGE.search(s) for s in good)


# -------------------------------------------------------- (c) drift guards


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_defaults_equal(name):
    j, t = getattr(jconfig, name)(), getattr(tconfig, name)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(t)] == [
        f.name for f in dataclasses.fields(j)]
    assert tconfig.config_to_json(t) == jconfig.config_to_json(j)
    assert port_config(j) == t


@pytest.mark.parametrize("preset,kw", [
    ("tiny_ssr_config", {}), ("tiny_ssr_config", {"num_layers": 3, "nhead": 2}),
    ("tiny_codec_config", {}), ("tiny_codec_config", {"renormalize": True})])
def test_config_presets_and_json_round_trip(preset, kw):
    j, t = getattr(jconfig, preset)(**kw), getattr(tconfig, preset)(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    back = (tconfig.ssr_config_from_json if "ssr" in preset
            else tconfig.codec_config_from_json)
    assert back(jconfig.config_to_json(j)) == t
    if "ssr" in preset:  # derived properties
        for prop in ("cardinality", "n_text_tokens", "text_pad_token",
                     "head_hidden_dim"):
            assert getattr(t, prop) == getattr(j, prop)
        assert t.tokens.mts == j.tokens.mts
    else:
        assert t.hop_length == j.hop_length


def test_patterns_outputs_equal():
    ts_j, ts_t = jconfig.TokenSpace(audio_vocab_size=32), tconfig.TokenSpace(
        audio_vocab_size=32)
    rng = np.random.default_rng(0)
    y = rng.integers(0, 32, size=(4, 60))
    spans = [(5, 12), (30, 41)]
    for fn, args in (("delay_pattern", (y, ts_j.empty)),
                     ("non_mask_intervals", (spans, 60))):
        np.testing.assert_array_equal(getattr(tpatterns, fn)(*args),
                                      getattr(jpatterns, fn)(*args))
    np.testing.assert_array_equal(
        tpatterns.revert_delay_pattern(tpatterns.delay_pattern(y, ts_t.empty)), y)
    for shuffle in (False, True):
        want = jpatterns.build_lm_sequence(y, spans, ts_j, shuffle,
                                           np.random.default_rng(4))
        got = tpatterns.build_lm_sequence(y, spans, ts_t, shuffle,
                                          np.random.default_rng(4))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    want = jpatterns.build_inference_prefix(y, spans, ts_j)
    got = tpatterns.build_inference_prefix(y, spans, ts_t)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    for dist in ("uniform", "poisson1"):
        kw = dict(mask_sample_dist=dist, max_n_spans=3)
        for seed in range(5):
            assert tpatterns.sample_mask_intervals(
                np.random.default_rng(seed), 300, tconfig.MaskingConfig(**kw)
            ) == jpatterns.sample_mask_intervals(
                np.random.default_rng(seed), 300, jconfig.MaskingConfig(**kw))
    nm = jpatterns.non_mask_intervals(spans, 60)
    gen = [rng.integers(0, 32, size=(4, n)) for n in (9, 3)]
    for a, b in zip(tpatterns.splice_generated(y, nm, gen, 60),
                    jpatterns.splice_generated(y, nm, gen, 60)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


EDIT_PAIRS = [
    ("but when i had approached so near to them",
     "but when i saw the mirage so near to them"),
    ("the quick brown fox", "the quick brown fox jumps over"),
    ("a b c d e f g", "a x c d f g h"),
    ("one two three", "one two three"),
    ("hello there", "completely different words here"),
]


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_edit_spans_equal(use_native, monkeypatch):
    if use_native:
        assert tnative.available() == jnative.available()
    else:
        monkeypatch.setattr(tnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    for orig, target in EDIT_PAIRS:
        for fn in ("parse_edit_en", "parse_tts_en"):
            assert getattr(tedit, fn)(orig, target) == getattr(jedit, fn)(
                orig, target), (fn, orig, target)
        assert tedit.align_ops(orig.split(), target.split()) == jedit.align_ops(
            orig.split(), target.split())
    zh = ("今天天气很好我们出去玩", "今天天气不错我们出去走走")
    for fn in ("parse_edit_zh", "parse_tts_zh"):
        assert getattr(tedit, fn)(*zh) == getattr(jedit, fn)(*zh)


def test_native_helpers_equal(tmp_path):
    """The port's copy of the native helper (its own .so, built beside it)
    and its Python fallbacks against the JAX package's."""
    assert Path(tnative._LIB_PATH).parent == Path(tnative.__file__).parent
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 2048, size=(4, 37))
    f = tmp_path / "codes.txt"
    f.write_text("\n".join(" ".join(str(v) for v in row) for row in codes))
    np.testing.assert_array_equal(tnative.parse_int_matrix(str(f)), codes)
    np.testing.assert_array_equal(tnative.parse_int_matrix(str(f)),
                                  jnative.parse_int_matrix(str(f)))
    rows = [rng.integers(0, 9, size=n).astype(np.int32) for n in (3, 7, 5)]
    np.testing.assert_array_equal(tnative.pad_collate(rows, 6, -1),
                                  jnative.pad_collate(rows, 6, -1))
    a, b = rng.integers(0, 5, size=12), rng.integers(0, 5, size=15)
    assert tnative.levenshtein_ops(a, b) == jnative.levenshtein_ops(a, b)


@pytest.mark.parametrize("n_slots", [1, 3, 8])
def test_sorted_static_batches_equal(n_slots):
    """The static scheduler: the same batches on requests with tied text
    lengths (the sort is stable), by default and with an estimate given."""
    rng = np.random.default_rng(n_slots)
    reqs = [(np.zeros(int(n)), None, [(0, 1)]) for n in
            rng.integers(3, 12, size=17)]
    assert tserve.sorted_static_batches(reqs, n_slots) == \
        jserve.sorted_static_batches(reqs, n_slots)
    est = lambda r: -len(r[0]) % 5  # noqa: E731
    assert tserve.sorted_static_batches(reqs, n_slots, est) == \
        jserve.sorted_static_batches(reqs, n_slots, est)
    assert tserve.sorted_static_batches([], n_slots) == []


@pytest.mark.parametrize("tmax,max_buckets", [
    (1, 8), (64, 8), (128, 8), (129, 8), (256, 8), (640, 8), (1000, 8),
    (1024, 8), (1536, 8), (2304, 8), (4096, 8), (10000, 8), (1024, 3),
    (1536, 16)])
def test_cache_stage_sizes_equal(tmax, max_buckets):
    """The decode graphs' stage windows are JAX's telescoping-cache stages
    (the port's copy of ``cache_stage_sizes``): the same sizes, each a
    multiple of 128 but the last, ending at ``tmax``."""
    from ssr_speech_tpu.models import transformer as jtrf
    from ssr_speech_tpu_torch.models import transformer as ttrf

    got = ttrf.cache_stage_sizes(tmax, max_buckets)
    assert got == jtrf.cache_stage_sizes(tmax, max_buckets)
    assert got[-1] == tmax and all(w % 128 == 0 for w in got[:-1])
    assert ttrf.stage_window(got, tmax + 1) == tmax
    assert all(ttrf.stage_window(got, w) == w for w in got)


def test_graph_module_is_guarded():
    """The decode loops' graph module is among the modules the import guard
    loads and the source scan reads."""
    assert "ssr_speech_tpu_torch.inference.graphs" in port_modules()
    assert REPO / "ssr_speech_tpu_torch" / "inference" / "graphs.py" in \
        scanned_sources()


def test_text_norm_outputs_equal():
    for n in (0, 7, 13, 21, 100, 101, 999, 1000, 1234, 20005, 1000000, 987654321):
        assert ttext.num_to_words_en(n) == jtext.num_to_words_en(n)
    for s in ("call 911 now", "in 1999 we had 42 apples", "no digits", "a1b22c"):
        assert ttext.replace_numbers_with_words(s) == jtext.replace_numbers_with_words(s)
    words = [("on", 0.0, 0.2), ("42nd", 0.2, 0.6), ("street", 0.6, 1.0)]
    assert ttext.normalize_aligned_words(words) == jtext.normalize_aligned_words(words)


@pytest.mark.parametrize("writer,reader", [(jaudio, taudio), (taudio, jaudio)],
                         ids=["jax_writes", "port_writes"])
def test_audio_written_by_one_read_by_the_other(writer, reader, tmp_path):
    rng = np.random.default_rng(1)
    wav = (rng.standard_normal((1, 4000)) * 0.2).astype(np.float32)
    path = str(tmp_path / "a.wav")
    writer.write_wav(path, wav, 16000)
    got, sr = reader.read_wav(path)
    want, sr_w = writer.read_wav(path)
    assert sr == sr_w == 16000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(reader.convert_audio(got, sr, 8000, 1),
                                  writer.convert_audio(want, sr, 8000, 1))
    np.testing.assert_array_equal(reader.load_for_codec(path, 16000),
                                  writer.load_for_codec(path, 16000))


@pytest.mark.parametrize("writer,reader", [(jckpt, tckpt), (tckpt, jckpt)],
                         ids=["jax_saves", "port_saves"])
def test_bundle_saved_by_one_loaded_by_the_other(writer, reader, tmp_path):
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "layers": [{"b": np.arange(5)}, {"b": np.arange(3)}]}
    cfg = tconfig.tiny_ssr_config()
    params = tree if writer is jckpt else {
        "w": torch.from_numpy(tree["w"]),
        "layers": [{"b": torch.from_numpy(d["b"])} for d in tree["layers"]]}
    path = str(tmp_path / "b.pkl")
    writer.save_bundle(path, params=params, phn2num={"a": 1},
                       model_config=dataclasses.asdict(cfg))
    got = reader.load_bundle(path)
    np.testing.assert_array_equal(got["params"]["w"], tree["w"])
    np.testing.assert_array_equal(got["params"]["layers"][1]["b"], np.arange(3))
    assert got["phn2num"] == {"a": 1}
    assert tconfig.ssr_config_from_json(json.dumps(got["model_config"])) == cfg
    for step in (1, 2, 3, 4):
        writer.save_step_checkpoint(str(tmp_path / "ck"), step, keep_last=2,
                                    params=params)
    assert reader.latest_checkpoint(str(tmp_path / "ck")) == str(
        tmp_path / "ck" / "ckpt_00000004.pkl")
    assert len(list((tmp_path / "ck").iterdir())) == 2
    assert reader.latest_checkpoint(str(tmp_path / "nothing")) is None


def test_port_save_bundle_stores_dataclass_configs_as_dicts(tmp_path):
    path = str(tmp_path / "c.pkl")
    tckpt.save_bundle(path, config=tconfig.tiny_codec_config(), params={})
    got = jckpt.load_bundle(path)
    assert isinstance(got["config"], dict)
    assert jconfig.codec_config_from_json(json.dumps(got["config"])
                                          ) == jconfig.tiny_codec_config()


def test_dataset_batcher_and_prefetch_give_the_same_batches(tmp_path):
    from tests.test_training import CFG as JCFG
    from tests.test_training import make_synth_corpus

    root = make_synth_corpus(tmp_path)
    kw = dict(dataset_dir=root, encodec_folder_name="codes", audio_min_length=2.0,
              audio_max_length=10.0, text_min_length=5, num_buckets=3,
              max_num_tokens=2000)
    jds = jdataset.SpeechDataset(JCFG, jconfig.DataConfig(**kw),
                                 jconfig.MaskingConfig(), "train", seed=3)
    tcfg = port_config(JCFG)
    tds = tdataset.SpeechDataset(tcfg, tconfig.DataConfig(**kw),
                                 tconfig.MaskingConfig(), "train", seed=3)
    assert tds.items == jds.items and tds.phn2num == jds.phn2num
    jb = jbatching.BucketBatcher(jds, JCFG, jconfig.DataConfig(**kw), seed=5)
    tb = tbatching.BucketBatcher(tds, tcfg, tconfig.DataConfig(**kw), seed=5)
    assert tb.bounds == jb.bounds and tb.pad_y == jb.pad_y
    assert tb.batches(0) == jb.batches(0)
    want = list(jprefetch.prefetch(jb, depth=2)(0))
    got = list(tprefetch.prefetch(tb, depth=2)(0))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert tbatching.lognormal_boundaries(900, 5) == jbatching.lognormal_boundaries(900, 5)


def test_watchdog_is_the_same_class_surface():
    for mod in (twatchdog, jwatchdog):
        w = mod.DeadlockDetect(use=False)
        w.update("step")
    assert [n for n in dir(twatchdog.DeadlockDetect) if not n.startswith("__")] == [
        n for n in dir(jwatchdog.DeadlockDetect) if not n.startswith("__")]


def test_port_modules_are_the_ports_own():
    """Every copied module is loaded from the port's tree, and the port's
    users reach that copy."""
    from ssr_speech_tpu_torch.inference import decode as tdecode
    from ssr_speech_tpu_torch.models import pretrained as tpretrained
    from ssr_speech_tpu_torch.training import trainer as ttrainer

    root = str(REPO / "ssr_speech_tpu_torch")
    for mod in (tconfig, tnative, tbatching, tdataset, tprefetch, tedit,
                tserve, tpatterns, taudio, tckpt, ttext, twatchdog,
                taudio_dataset, tsamples, tvisqol, twm, tconvert, tprep,
                tasr, tforced_align, tquality):
        assert importlib.import_module(mod.__name__).__file__.startswith(root)
    assert tdecode.patterns is tpatterns
    assert tpretrained.save_bundle is tckpt.save_bundle
    assert tpretrained.save_step_checkpoint is tckpt.save_step_checkpoint
    assert ttrainer.DeadlockDetect is twatchdog.DeadlockDetect
    # the sharded pair is the port's own (torch.distributed.checkpoint),
    # not a copy of the orbax one
    assert tckpt.save_sharded.__module__ == tckpt.load_sharded.__module__ \
        == tckpt.__name__
    assert "import orbax" not in inspect.getsource(tckpt)
    assert not hasattr(tpatterns, "revert_delay_jnp")


# ------------------------------------------- the codec trainer's host copies


@pytest.mark.parametrize("loader_threads", [0, 2], ids=["python", "native"])
def test_audio_dataset_gives_the_same_batches(tmp_path, loader_threads):
    """The same manifest and seed through both copies: the same sampling
    probabilities, file picks, seeks and padded segments, batch by batch,
    over a corpus with weights, a short file and a file needing a
    resample."""
    rng = np.random.default_rng(4)
    lines = []
    for i, (dur, sr, w) in enumerate([(1.0, 16000, 2.0), (0.3, 16000, None),
                                      (0.8, 8000, 0.5)]):
        path = str(tmp_path / f"w{i}.wav")
        jaudio.write_wav(path, (rng.standard_normal((1, int(dur * sr))) * 0.1
                                ).astype(np.float32), sr)
        meta = dict(path=path, duration=dur, sample_rate=sr)
        if w is not None:
            meta["weight"] = w
        lines.append(json.dumps(meta))
    mf = tmp_path / "m.jsonl"
    mf.write_text("\n".join(lines))
    jcfg = jconfig.tiny_codec_config()
    kw = dict(segment_duration=0.5, seed=9, loader_threads=loader_threads,
              min_segment_ratio=0.7)
    jds = jaudio_dataset.AudioSegmentDataset(str(mf), jcfg, **kw)
    tds = taudio_dataset.AudioSegmentDataset(str(mf), port_config(jcfg), **kw)
    np.testing.assert_array_equal(tds.sampling_probabilities,
                                  jds.sampling_probabilities)
    assert tds.segment_samples == jds.segment_samples
    for a, b in zip(tds.batches(3, 4), jds.batches(3, 4)):
        np.testing.assert_array_equal(a, b)


def test_sample_manager_stores_the_same_files(tmp_path):
    rng = np.random.default_rng(5)
    wavs = [(rng.standard_normal((1, 800)) * 0.1).astype(np.float32)
            for _ in range(3)]
    roots = {}
    for name, mod in (("jax", jsamples), ("port", tsamples)):
        sm = mod.SampleManager(str(tmp_path / name))
        ids = [sm.add_sample(wavs[0], 16000, epoch=1, conditioning={"i": 0}),
               sm.add_sample(wavs[0], 16000, epoch=1),
               sm.add_sample(wavs[1][0], 16000, epoch=2, prompt_wav=wavs[2][0])]
        metas = [{k: v for k, v in m.items() if k != "time"}
                 for m in sm.get_samples()]
        roots[name] = (ids, metas, sorted(
            str(p.relative_to(tmp_path / name))
            for p in (tmp_path / name).rglob("*")))
    assert roots["port"] == roots["jax"]


def test_visqol_hook_drives_the_same_protocol(tmp_path):
    """Both hooks against one stub binary that records its command line and
    inputs: the same flags, the same resampled PCM files, the same score."""
    import stat

    from tests.test_visqol import STUB

    log = tmp_path / "calls.txt"
    stub = STUB.replace("rows = list(", f"open({str(log)!r}, 'a').write("
                        "repr(sorted(a for a in sys.argv[1:] if a.startswith("
                        "'--'))) + chr(10))\nrows = list(")
    (tmp_path / "bazel-bin").mkdir()
    (tmp_path / "model").mkdir()
    exe = tmp_path / "bazel-bin" / "visqol"
    exe.write_text(stub)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    rng = np.random.default_rng(6)
    ref = [rng.standard_normal(8000) * 0.1 for _ in range(2)]
    deg = [r + rng.standard_normal(8000) * 0.01 for r in ref]
    scores = [mod.ViSQOL(tmp_path, mode="speech")(ref, deg, sr=8000,
                                                  pad_with_silence=True)
              for mod in (jvisqol, tvisqol)]
    assert scores[0] == scores[1] == pytest.approx(4.25)
    calls = log.read_text().splitlines()
    assert len(calls) == 2 and calls[0] == calls[1]
    for x in (ref[0], deg[1]):
        np.testing.assert_array_equal(tvisqol._resample(x, 8000, 16000),
                                      jvisqol._resample(x, 8000, 16000))
    with pytest.raises(FileNotFoundError):
        tvisqol.ViSQOL(tmp_path / "nope")


@pytest.mark.parametrize("min_regions,max_regions", [(0, 2), (1, 3)])
def test_watermark_mask_sampler_is_the_same(min_regions, max_regions):
    for seed in range(6):
        got = twm.sample_watermark_mask(np.random.default_rng(seed), 4, 30, 40,
                                        min_regions, max_regions)
        want = jwm.sample_watermark_mask(np.random.default_rng(seed), 4, 30, 40,
                                         min_regions, max_regions)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ------------------------------------------- the lifecycle's host copies


def test_convert_helpers_give_the_same_leaves():
    """The converter's layout helpers on one seeded state dict: weight-norm
    and plain convs, a transposed conv, a resblock and a 2-layer LSTM."""
    import jax

    rng = np.random.default_rng(12)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sd = {"c.conv.conv.bias": r(4), "c.conv.conv.weight_v": r(4, 3, 5),
          "c.conv.conv.weight_g": r(4, 1, 1), "p.conv.conv.bias": r(2),
          "p.conv.conv.weight": r(2, 4, 1), "t.convtr.convtr.bias": r(3),
          "t.convtr.convtr.weight_v": r(4, 3, 6),
          "t.convtr.convtr.weight_g": r(4, 1, 1)}
    for blk, (co, ci, k) in (("block.1", (2, 4, 3)), ("block.3", (4, 2, 1))):
        sd[f"r.{blk}.conv.conv.bias"] = r(co)
        sd[f"r.{blk}.conv.conv.weight"] = r(co, ci, k)
    for i in range(2):
        sd.update({f"l.lstm.weight_ih_l{i}": r(16, 4),
                   f"l.lstm.weight_hh_l{i}": r(16, 4),
                   f"l.lstm.bias_ih_l{i}": r(16),
                   f"l.lstm.bias_hh_l{i}": r(16)})
    calls = [("_conv_params", "c"), ("_conv_params", "p"),
             ("_convtr_params", "t"), ("_resblock_params", "r"),
             ("_lstm_params", "l", 2)]
    for name, *args in calls:
        got = getattr(tconvert, name)(sd, *args)
        want = getattr(jconvert, name)(sd, *args)
        assert jax.tree.structure(got) == jax.tree.structure(want), name
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)


def test_forced_align_outputs_equal():
    rng = np.random.default_rng(13)
    for trial in range(6):
        T, V = int(rng.integers(20, 60)), int(rng.integers(4, 9))
        lp = rng.normal(size=(T, V))
        lp = lp - np.log(np.exp(lp).sum(axis=1, keepdims=True))
        tokens = [int(t) for t in rng.integers(1, V, size=int(rng.integers(1, 8)))]
        spans = tforced_align.ctc_forced_align(lp, tokens, blank=0)
        assert spans == jforced_align.ctc_forced_align(lp, tokens, blank=0)
        strings = [("|" if t == V - 1 else chr(97 + t)) for t in tokens]
        assert (tforced_align.tokens_to_word_times(spans, strings, 0.02)
                == jforced_align.tokens_to_word_times(spans, strings, 0.02))


def test_numeral_suppress_ids_equal():
    rng = np.random.default_rng(14)
    pieces = ["".join(rng.choice(list(" 0123456789ab"), size=int(n)))
              for n in rng.integers(0, 5, size=60)]

    class Tok:
        eos_token_id = len(pieces)

        def decode(self, ids):
            return "".join(pieces[i] for i in ids)

        def __len__(self):
            return len(pieces)

    got = tasr.numeral_suppress_ids(Tok())
    assert got == jasr.numeral_suppress_ids(Tok()) and got
    assert tasr.numeral_suppress_ids(Tok(), upto=20) == \
        jasr.numeral_suppress_ids(Tok(), upto=20)


def test_quality_text_metrics_equal():
    rng = np.random.default_rng(15)
    words = ["the", "Cat", "sat,", "on", "42", "mats!", "today", "7th"]
    for _ in range(20):
        ref = " ".join(rng.choice(words, size=int(rng.integers(0, 8))))
        hyp = " ".join(rng.choice(words, size=int(rng.integers(0, 8))))
        for lang in ("en", "zh"):
            assert (tquality.normalize_text(ref, lang)
                    == jquality.normalize_text(ref, lang))
            assert tquality.wer(ref, hyp, lang) == jquality.wer(ref, hyp, lang)
            assert tquality.cer(ref, hyp, lang) == jquality.cer(ref, hyp, lang)


def test_prep_helpers_write_the_same(tmp_path):
    """GigaSpeech tag round trip (each package on its own tokenizer),
    ``filemaker`` and ``vocab`` on one seeded corpus."""
    import argparse

    rng = np.random.default_rng(16)
    tags = ["<COMMA>", "<PERIOD>", "<SIL>", "<MUSIC>", "<NOISE>", "<OTHER>",
            "<QUESTIONMARK>", "#%#"]
    toks = (jtokenizer.TextTokenizer(), ttokenizer.TextTokenizer())
    segs = []
    for i in range(12):
        words = list(rng.choice(["a", "bit", "of", "text", "here"],
                                size=int(rng.integers(2, 7))))
        words.insert(int(rng.integers(0, len(words))), str(rng.choice(tags)))
        text = " ".join(words)
        want = jprep.gs_phonemize_text(toks[0], text)
        assert tprep.gs_phonemize_text(toks[1], text) == want
        assert tprep.gs_word2sym(toks[1]) == jprep.gs_word2sym(toks[0])
        seg = f"s{i}"
        if want is not None:
            (tmp_path / "phn").mkdir(exist_ok=True)
            (tmp_path / "phn" / f"{seg}.txt").write_text(want)
        if i % 3:
            (tmp_path / "codes").mkdir(exist_ok=True)
            n = int(rng.integers(5, 40))
            (tmp_path / "codes" / f"{seg}.txt").write_text(
                " ".join(["1"] * n) + "\n" + " ".join(["2"] * n))
        segs.append(f"{seg}\t{text}")
    (tmp_path / "m.tsv").write_text("\n".join(segs))
    for name, mod in (("j", jprep), ("t", tprep)):
        mod.cmd_filemaker(argparse.Namespace(
            manifest=str(tmp_path / "m.tsv"), phn_dir=str(tmp_path / "phn"),
            codes_dir=str(tmp_path / "codes"), min_frames=10,
            output=str(tmp_path / name / "train.txt")))
        mod.cmd_vocab(argparse.Namespace(phn_dir=str(tmp_path / "phn"),
                                         output=str(tmp_path / f"{name}.txt")))
    assert ((tmp_path / "t" / "train.txt").read_bytes()
            == (tmp_path / "j" / "train.txt").read_bytes())
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()

