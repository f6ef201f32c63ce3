"""The open-loop batched engine (``BatchedPuschPipeline.run``) against
``repro``: a per-UE scenario under a mixed mode grid, so the per-UE switch
serves both experts within one slot.  The policy profiling runs this loop
once per expert."""

import jax
import numpy as np
import pytest
import torch

from repro.phy import ai_estimator as rai
from repro.phy import pipeline as rpipe
from repro.phy.nr import SlotConfig as RSlotConfig
from repro.phy.scenario import get_scenario as rget
from repro_torch.convert import ai_params_from_reference
from repro_torch.core.session import ArchesSession, CampaignSpec
from repro_torch.phy import ai_estimator as tai
from repro_torch.phy import pipeline as tpipe
from repro_torch.phy.nr import SlotConfig
from repro_torch.phy.scenario import get_scenario as tget

# one intra-op thread: the suite runs several workers on the same cores
torch.set_num_threads(1)

N_PRB, N_UES, N_SLOTS = 24, 3, 6
NET = dict(channels=8, n_res_blocks=1)
#: as in test_torch_campaign: float32 stages agree to a few ulp each
KPM_RTOL, KPM_ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(5)
    modes = rng.integers(0, 2, size=(N_SLOTS, N_UES)).astype(np.int32)
    modes[0] = (0, 1, 0)
    ref_params = rai.init_params(jax.random.PRNGKey(0), RSlotConfig(n_prb=N_PRB),
                                 rai.AiEstimatorConfig(**NET))
    reng = rpipe.BatchedPuschPipeline(RSlotConfig(n_prb=N_PRB), ref_params,
                                      net=rai.AiEstimatorConfig(**NET))
    _, rtraj = reng.run(rget("mixed_cell").schedule(n_ues=N_UES), modes, n_slots=N_SLOTS,
                        n_ues=N_UES, key=jax.random.PRNGKey(4))
    teng = tpipe.BatchedPuschPipeline(SlotConfig(n_prb=N_PRB),
                                      ai_params_from_reference(ref_params),
                                      net=tai.AiEstimatorConfig(**NET), device="cpu")
    _, ttraj = teng.run(tget("mixed_cell").schedule(n_ues=N_UES), modes, n_slots=N_SLOTS,
                        n_ues=N_UES, key=np.asarray(jax.random.PRNGKey(4)))
    return modes, rtraj, ttraj, teng


def test_discrete_leaves_bitwise(runs):
    _, rtraj, ttraj, _ = runs
    for k in ("mcs", "tb_ok", "tbs", "executed_flops", "gated_overflow"):
        np.testing.assert_array_equal(ttraj[k].numpy(), np.asarray(rtraj[k]), err_msg=k)


def test_kpms_within_tolerance(runs):
    _, rtraj, ttraj, _ = runs
    for src in rtraj["kpms"]:
        for k, want in rtraj["kpms"][src].items():
            got = ttraj["kpms"][src][k].numpy()
            assert got.shape == (N_SLOTS, N_UES)
            np.testing.assert_allclose(got, np.asarray(want), rtol=KPM_RTOL, atol=KPM_ATOL,
                                       err_msg=f"{src}.{k}")


def test_bank_serves_each_ue_its_mode(runs):
    """Swapping the mode grid changes exactly the UEs whose mode changed."""
    modes, _, ttraj, teng = runs
    flipped = modes.copy()
    flipped[:, 1] = 1 - flipped[:, 1]
    _, traj = teng.run(tget("mixed_cell").schedule(n_ues=N_UES), flipped, n_slots=N_SLOTS,
                       n_ues=N_UES, key=np.asarray(jax.random.PRNGKey(4)))
    rsrp, rsrp0 = traj["kpms"]["aerial"]["rsrp"].numpy(), ttraj["kpms"]["aerial"]["rsrp"].numpy()
    np.testing.assert_array_equal(rsrp[:, [0, 2]], rsrp0[:, [0, 2]])
    assert not np.array_equal(rsrp[:, 1], rsrp0[:, 1])
    # the switch kernel writes in place: every expert hands it a dense buffer
    h_ls = torch.zeros((N_UES, 4, 3, SlotConfig(n_prb=N_PRB).n_pilot_sc), dtype=torch.complex64)
    for expert in teng.bank.experts:
        assert expert.fn(expert.params, h_ls).is_contiguous(), expert.name


def test_batched_session_path_bf16_expert():
    """The open-loop ``batched`` session path with the bf16-operand expert."""
    spec = CampaignSpec(path="batched", scenario="good_poor_good", n_ues=2, n_slots=4,
                        n_prb=N_PRB, modes=0, scenario_args=(("poor_start", 1),
                                                             ("poor_end", 3)))
    f32 = ArchesSession(spec, device="cpu").run()
    bf = ArchesSession(CampaignSpec.from_dict(dict(spec.to_dict(), bank=dict(
        spec.to_dict()["bank"], dtype="bfloat16"))), device="cpu").run()
    assert bf.modes.shape == (4, 2) and (bf.modes == 0).all()
    for k, v in bf.kpms.items():
        assert np.isfinite(v).all(), k
    assert not np.array_equal(bf.kpms["rsrp"], f32.kpms["rsrp"])
    assert torch.equal(torch.as_tensor(bf.outputs["executed_flops"]),
                       torch.as_tensor(f32.outputs["executed_flops"]))
