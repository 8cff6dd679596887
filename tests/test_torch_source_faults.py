"""chip_smoke.py's planted source faults, checked on the CPU.

``python3 chip_smoke.py --source-faults`` edits a copy of one kernel source
per fault and runs the cases of that kernel on the card, which must reject
it. A fault whose text is no longer in its source stops that run on the card
at its first such fault; here every fault's text is found in its source
under edm_tts_tpu_torch/csrc, each replacement changes the text, and each
source has the chip_smoke.py mode whose cases hold its kernels.
"""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "edm_tts_tpu_torch" / "csrc"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP_SMOKE = _chip_smoke()
# the sources whose faults the --attention-kernels cases (the default mode) hold
DEFAULT_MODE_SOURCES = ("attention.cu", "attention_bwd.cu", "attn_variants.cu")


@pytest.mark.parametrize("name", sorted(CHIP_SMOKE.SOURCE_FAULTS))
def test_fault_text_is_in_its_source(name):
    source, edits = CHIP_SMOKE.SOURCE_FAULTS[name]
    text = (CSRC / source).read_text()
    for old, new in edits:
        assert old in text and old != new, (source, old)
    assert source in CHIP_SMOKE.FAULT_MODES or source in DEFAULT_MODE_SOURCES


def test_f32_attention_faults_run_the_f32_cases():
    """The f32 attention kernels' faults (their own sources and the staging
    header they share) run under --f32-kernels, which holds K3-f32 and
    K4-f32, and each kernel has faults of its own."""
    for source in ("attention_f32.cu", "attention_bwd_f32.cu", "attn_f32.cuh"):
        assert CHIP_SMOKE.FAULT_MODES[source] == "--f32-kernels"
    sources = {src for src, _ in CHIP_SMOKE.SOURCE_FAULTS.values()}
    assert {"attention_f32.cu", "attention_bwd_f32.cu", "attn_f32.cuh"} <= sources
