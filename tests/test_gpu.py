"""The committed reference goldens, driven through the CLI on a GPU.

On the card stage 00 runs its device engine (the CPU runs the host
engine), so these are the parity checks of the device path.  They skip
without a GPU; ``python chip_smoke.py`` runs the same drives.
"""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def test_classify_golden_on_gpu(gpu, tmp_path):
    chip_smoke.golden_classify(str(tmp_path))


def test_e2e_trio_golden_on_gpu(gpu, tmp_path):
    chip_smoke.golden_e2e(str(tmp_path))


def test_stage00_golden_on_gpu(gpu, tmp_path):
    chip_smoke.golden_stage00(str(tmp_path))
