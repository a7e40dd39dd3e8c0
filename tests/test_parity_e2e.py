"""End-to-end parity vs the full torch reference pipeline.

Drives scripts/parity_e2e.py's harness at the small size: one set of
weights built in torch (HF modules + peft LoRA, tests/torch_reference),
ported through the PRODUCTION checkpoint-import path
(models/reference_import.port_reference_state_dict), identical synthetic
media through both frameworks — losses, sim matrices, retrieval ranks,
and a 3-step 4-group-AdamW training trajectory must agree at fp32
tolerance (BASELINE configs 1-4 + the training-semantics leg).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")
pytest.importorskip("peft")

TOL = 5e-5  # fp32 end-to-end (12-layer chains accumulate ~1e-6 per op)


@pytest.fixture(scope="module")
def harness():
    from scripts.parity_e2e import Harness

    return Harness("small", seed=0)


@pytest.mark.slow
class TestEndToEndParity:
    def test_config1_tv_loss(self, harness):
        r = harness.leg_tv()
        assert r["d_total"] < TOL
        assert r["d_contrastive"] < TOL
        assert r["d_reg"] < TOL
        assert r["d_clip_sims"] < TOL

    def test_config2_av_loss(self, harness):
        r = harness.leg_av()
        assert r["d_total"] < TOL
        assert r["d_smooth"] < TOL
        assert r["d_clip_sims"] < TOL

    def test_config3_trimodal_sims(self, harness):
        r = harness.leg_trimodal()
        assert r["d_vis_text_sim_matrix"] < TOL
        assert r["d_vis_audio_sim_matrix"] < TOL
        assert r["d_text_audio_sim_matrix"] < TOL

    def test_config4_retrieval_ranks_identical(self, harness):
        r = harness.leg_retrieval(12)
        for k, v in r.items():
            if k.startswith("d_") and "viz" not in k:
                assert v == 0.0, f"{k}: recall mismatch {v}"
        assert r["d_viz_sims"] < TOL
        assert r["d_viz_heatmap_grid"] < TOL

    def test_config5_train_trajectory(self, harness):
        r = harness.leg_train_steps(3)
        assert r["d_max"] < 1e-4, (
            f"per-step losses diverged: {r['d_per_step']}"
        )
        assert r["d_temperature"] < 1e-5


@pytest.mark.slow
def test_via_file_checkpoint_round_trip():
    """The weights must survive a
    full torch.save -> disk -> load_reference_checkpoint round trip (the
    reference's checkpoint_epoch{E}_step{S}.pt payload layout incl. the
    torch.compile ``_orig_mod.`` prefix), leaving only the download
    itself untested in this zero-egress image."""
    from scripts.parity_e2e import Harness

    h = Harness("small", seed=0, via_file=True)
    r = h.leg_tv()
    assert r["d_total"] < TOL
    r = h.leg_av()
    assert r["d_total"] < TOL
