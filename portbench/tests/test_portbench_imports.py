"""In a fresh interpreter: nothing the harness loads brings in JAX or the JAX
package (top-level names compared whole), and the reference loads nothing
of the port."""

import json
import subprocess
import sys

from portbench.lib import common

HARNESS = """
import sys, json
sys.path.insert(0, {root!r})
import portbench.run
from portbench.lib import common, harness, port, profile, traffic, weights
for loop in ("edit_closed", "encode_closed"):
    common.loop(loop)
for m in common.benchmark()["per_layer"]:
    common.metric_reader(m["name"])
import ssr_speech_tpu_torch.inference.decode, ssr_speech_tpu_torch.inference.pipeline
import ssr_speech_tpu_torch.models.codec.wmencodec, ssr_speech_tpu_torch.data.tokenizer
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE = """
import sys, json
sys.path.insert(0, {root!r})
import portbench.reference.lm, portbench.reference.codec, portbench.reference.patterns
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(common.ROOT))],
                         capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax():
    mods = _modules(HARNESS)
    assert "ssr_speech_tpu_torch" in mods
    assert common.forbidden_loaded(mods) == []


def test_guard_compares_whole_names():
    assert common.forbidden_loaded(["ssr_speech_tpu_torch.ops"]) == []
    assert common.forbidden_loaded(["ssr_speech_tpu.models"]) == ["ssr_speech_tpu"]
    assert common.forbidden_loaded(["jaxlib.xla", "jax"]) == ["jax", "jaxlib"]
    assert common.forbidden_loaded(["jaxtyping"]) == []


def test_reference_loads_nothing_of_the_port():
    mods = _modules(REFERENCE)
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"ssr_speech_tpu_torch", "ssr_speech_tpu", "jax", "jaxlib"}
