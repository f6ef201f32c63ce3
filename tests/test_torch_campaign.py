"""The whole slice: the committed benchmark snapshot's closed-loop campaign
spec, run through both packages.

``repro`` fits its switching tree on its own profiled KPMs; that fitted tree
is carried across (fitted thresholds sit at midpoints of KPM values, so a
tree fitted on the port's KPMs could differ by float noise).  The port
draws its AI weights from ``params_seed`` with its own PRNG.  Discrete
leaves are compared and their agreement reported; continuous leaves carry
a tolerance.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import session as rses
from repro_torch.convert import tree_policy_from_reference
from repro_torch.core import session as tses

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

BENCH_SPEC = json.loads(
    (Path(__file__).resolve().parents[1] / "BENCH_pr10.json").read_text())["campaign_spec"]

#: continuous KPMs of a campaign whose discrete path (modes, MCS, TB outcome)
#: agrees: every stage in between is float32 with a few ulp of reassociation
#: per stage (channel steering, GEMMs, equalizer), and the SNR feeds back
#: into link adaptation through the slot loop; 1e-4 relative is far below a
#: tenth of a dB and far above the accumulated rounding seen
KPM_RTOL, KPM_ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def both():
    rsess = rses.ArchesSession(rses.CampaignSpec.from_dict(BENCH_SPEC))
    rhist = rsess.run()
    tree = rsess.host_policies[0].tree
    host = tree_policy_from_reference(tree.feature, tree.threshold, tree.leaf_values,
                                      tuple(BENCH_SPEC["feature_names"]))
    tsess = tses.ArchesSession(tses.CampaignSpec.from_dict(BENCH_SPEC), device="cpu",
                               host_policies=(host,))
    thist = tsess.run()
    return rsess, rhist, tsess, thist


def test_modes_and_discrete_leaves_agree(both):
    _, rhist, _, thist = both
    assert thist.modes.shape == rhist.modes.shape == (12, 2)
    agree = (thist.modes == rhist.modes).mean()
    print(f"active_mode agreement {agree:.4f}")
    assert agree == 1.0
    np.testing.assert_array_equal(thist.decisions, rhist.decisions)
    np.testing.assert_array_equal(thist.n_switches, rhist.n_switches)
    assert thist.n_switches.sum() >= 2  # the campaign really switched, both ways
    for k in ("mcs", "tb_ok", "tbs"):
        np.testing.assert_array_equal(thist.outputs[k], rhist.outputs[k], err_msg=k)


def test_continuous_leaves_within_tolerance(both):
    _, rhist, _, thist = both
    assert set(thist.kpms) == set(rhist.kpms)
    worst = 0.0
    for k, want in rhist.kpms.items():
        got = thist.kpms[k]
        assert np.isfinite(got).all(), k
        worst = max(worst, float(np.max(np.abs(got - want) / (np.abs(want) + KPM_ATOL))))
        np.testing.assert_allclose(got, want, rtol=KPM_RTOL, atol=KPM_ATOL, err_msg=k)
    np.testing.assert_allclose(thist.outputs["phy_bits_per_s"], rhist.outputs["phy_bits_per_s"],
                               rtol=KPM_RTOL)
    print(f"max relative KPM difference {worst:.3g}")
    np.testing.assert_array_equal(thist.outputs["executed_flops"],
                                  rhist.outputs["executed_flops"])
    assert thist.ai_share == rhist.ai_share


def test_device_loop_equals_host_replay(both):
    _, _, tsess, thist = both
    replay = tsess.host_replay(thist)
    np.testing.assert_array_equal(thist.modes, replay["active_mode"])
    np.testing.assert_array_equal(thist.decisions, replay["raw_decision"])
    np.testing.assert_array_equal(thist.n_switches, replay["n_switches"])


def test_port_fits_its_own_tree():
    """Without a carried tree the port profiles and fits its own, as the
    reference does; the campaign runs and the register contract holds."""
    spec = tses.CampaignSpec.from_dict(dict(BENCH_SPEC, n_slots=9, scenario_args=(
        ("poor_start", 3), ("poor_end", 6))))
    sess = tses.ArchesSession(spec, device="cpu")
    hist = sess.run()
    assert hist.modes.shape == (9, 2)
    assert sess.host_policies[0].tree.depth == 2
    np.testing.assert_array_equal(hist.modes, sess.host_replay(hist)["active_mode"])
