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
  adaptation and scaling tables and, for fleets, the per-worker
  utilization table.
* :mod:`repro_torch.campaign.distrib` — multi-worker fleets: deterministic
  batch sharding, shared-nothing worker loops under ``worker-<i>/`` with
  liveness leases, and the crash-safe reconciler that merges worker run
  directories into the top-level frontier.
* :mod:`repro_torch.campaign.transfer` — cross-campaign transfer:
  warm-start new campaigns from completed run directories
  (``--transfer-from``) and fit the persistent cost model
  (``repro_torch.models.cost_model``) whose predicted episodes-to-feasible
  order the batches.

CLI: ``python -m repro_torch.launch.dse --campaign grid.json [--workers
W]`` / ``--resume <run-dir>``.
"""
from repro_torch.campaign.planner import Cell, CellBatch, CampaignSpec, plan
from repro_torch.campaign.report import (write_index_report, write_reports,
                                         write_scaling_report)
from repro_torch.campaign.runner import run_campaign
from repro_torch.campaign.store import CampaignStore, merge_runs
from repro_torch.campaign.distrib import (fingerprint, reconcile,
                                          run_worker, shard_batches)
# last: transfer imports the modules above and pulls in the serving layer
# lazily
from repro_torch.campaign.transfer import (load_warm_start, prepare_store,
                                           with_transfer)

__all__ = ["Cell", "CellBatch", "CampaignSpec", "plan", "run_campaign",
           "CampaignStore", "merge_runs", "write_reports",
           "write_index_report", "write_scaling_report", "fingerprint",
           "reconcile", "run_worker", "shard_batches", "load_warm_start",
           "prepare_store", "with_transfer"]
