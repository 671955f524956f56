"""Oracle parity on the card: the engine's fused source-pair step at 4K
and the small-frame flow/warp matrix in every output mode.

These need a GPU and skip elsewhere (the ``gpu`` fixture);
``python chip_smoke.py`` runs them on the card, in its own process.  The
CPU suite proves the same semantics bit-exact on the CPU backend
(test_flow_golden, test_warp_golden, test_engine).
"""

import pytest

from mpv_frame_interpolator.utils import parity

pytestmark = pytest.mark.gpu


def _failures(rows):
    return [r for r in rows if not r[1]]


@pytest.mark.parametrize("sampling", ["shift", "gather"])
@pytest.mark.parametrize("content", ["moving_box", "gradient_pan"])
def test_timed_path_4k_matches_oracle(gpu, content, sampling):
    """24->120 at 3840x2160, radius 16, both warp samplers.  Scene
    detection is off so the warp runs on the measured flow even where
    the detector would call gradient_pan's 4K pairs cuts (chip_smoke's
    parity phase checks the CLI's default, scene detection on)."""
    rows = parity.timed_path_parity(content, n_pairs=1,
                                    scene_detection=False,
                                    warp_sampling=sampling)
    assert len(rows) == 1 + 5
    assert not _failures(rows), _failures(rows)


def test_parity_matrix(gpu):
    rows = parity.run_parity(parity.FULL_CASES,
                             modes=tuple(parity.MODE_NAMES), levels=True)
    assert len(rows) == len(parity.FULL_CASES) * (
        2 + len(parity.MODE_NAMES))
    assert not _failures(rows), _failures(rows)
