"""Campaign subsystem (port of ``repro.campaign``): persistent
multi-workload x multi-node design-space-exploration sweeps on the batched
``VecDSEEnv`` engine.

* :mod:`repro_torch.campaign.planner` — expands a grid spec into cells and
  packs them into mixed-node batches.
* :mod:`repro_torch.campaign.runner`  — drives ``run_search_cells`` per
  batch with periodic checkpointing; a killed campaign resumes from the
  last completed chunk, bit-for-bit.
* :mod:`repro_torch.campaign.store`   — the reference's JSONL run directory
  layout, manifest and dominance-filtered archive merging.
* :mod:`repro_torch.campaign.report`  — per-cell best-PPA, cross-node
  adaptation and scaling tables.

Fleets, cross-campaign transfer and telemetry are not ported yet.

CLI: ``python -m repro_torch.launch.dse --campaign grid.json`` /
``--resume <run-dir>``.
"""
from repro_torch.campaign.planner import Cell, CellBatch, CampaignSpec, plan
from repro_torch.campaign.report import write_reports, write_scaling_report
from repro_torch.campaign.runner import run_campaign
from repro_torch.campaign.store import CampaignStore, merge_runs

__all__ = ["Cell", "CellBatch", "CampaignSpec", "plan", "run_campaign",
           "CampaignStore", "merge_runs", "write_reports",
           "write_scaling_report"]
