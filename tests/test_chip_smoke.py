"""chip_smoke.py off the card: it refuses to run without a GPU, and its
phases run end to end at tiny sizes on the CPU (the four-card phase on
four virtual CPU devices)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_chip_smoke_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_phase_kernels_tiny():
    found = chip_smoke.phase_kernels(sizes=((16, 200),), seed=1)
    assert found[(16, 200)]["felz_agree"] == 1.0
    assert found[(16, 200)]["flood_agree"] == 1.0


@pytest.mark.parametrize("use_flow", [True, False])
def test_phase_main_tiny(use_flow):
    found = chip_smoke.phase_main(width=64, height=48, frames=24, seed=2,
                                  use_flow=use_flow)
    assert found["frames"] == 24 and found["chunk_starts"] >= 1
    assert found["levels"] >= 2


def test_phase_banded_tiny():
    found = chip_smoke.phase_banded(width=64, height=48, frames=24, seed=3,
                                    max_solve_voxels=21 * 64 * 24)
    assert found["bands"] >= 2


def test_phase_gpu_vs_cpu_tiny():
    found = chip_smoke.phase_gpu_vs_cpu(width=64, height=48, crop=(32, 64),
                                        seed=4)
    assert found["repeatable"] and found["boundary_f"] == 1.0


def test_phase_four_cards_virtual_devices():
    found = chip_smoke.phase_four_cards(width=64, height=32, frames=40,
                                        seed=5, regions=60, devices=4)
    assert found["dense_equal"] and found["agglomeration_equal"]
