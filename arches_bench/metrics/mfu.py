"""The whole step's share of the card's peak: the experts' work as the
algorithms need it (``arches_bench.counts``: the Wiener interpolation on
every UE, the CNN on the UEs it ran on, ``ai_rows`` of
``programs/arches_campaign.py``) over the window's campaigns, against
the window's host time at the TF32 rate."""

from arches_bench import counts


def read(run):
    cfg, bank = run.cell.config, run.cell.config["bank"]
    rows = run.cell.n_ues * run.cell.n_ant * run.cell.n_dmrs_sym
    flops = 0.0
    for c in run.campaigns:
        flops += run.cell.n_slots * counts.mmse_interp(cfg["n_prb"], rows)[0]
        flops += sum(counts.ai_expert(cfg["n_prb"], run.cell.n_ant, run.cell.n_dmrs_sym, bank["channels"],
                                      bank["n_res_blocks"], int(n))[0]
                     for n in run.program.ai_rows(run.cell, c))
    return 100.0 * flops / (run.window_s * counts.PEAK_TF32_FLOPS)
