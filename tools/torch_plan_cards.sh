#!/bin/bash
# Plan full-depth Yi-6B for the cards of this machine (launch.plan
# --devices 0; four H100s) and run the plan through
# tools/torch_pipeline_cards.py; then plan with four stages only and run
# that plan (its embedded tick table) the same way.  From the repository
# root:  bash tools/torch_plan_cards.sh [OUT]
# Plans go to build/cards4/, each rank's records to OUT (build/cards4).
set -e
export PYTHONPATH=src
OUT=${1:-build/cards4}
mkdir -p build/cards4 "$OUT"
python -m repro_torch.launch.plan --arch yi-6b --stages 1,2,4 --global-batch 8 --seq-len 2048 \
    --microbatches 1,2,4,8 --out build/cards4/plan.json
python - <<'PY'
import json
doc = json.load(open("build/cards4/plan.json"))
print("devices", doc["devices"])
for r in doc["plans"][:6] + [r for r in doc["plans"] if r["stages"] == 4][:3]:
    print("row", {k: r[k] for k in ("mesh", "stages", "schedule", "split_backward", "method",
                                   "partitioned", "microbatches", "score_step_s", "compute_s",
                                   "data_coll_s", "tp_coll_s", "p2p_s")})
PY
python -m torch.distributed.run --standalone --nproc_per_node 4 tools/torch_pipeline_cards.py \
    "$OUT" plan --plan build/cards4/plan.json
python -m repro_torch.launch.plan --arch yi-6b --stages 4 --global-batch 8 --seq-len 2048 \
    --microbatches 1,2,4,8 --out build/cards4/plan4.json
python -m torch.distributed.run --standalone --nproc_per_node 4 tools/torch_pipeline_cards.py \
    "$OUT" stages4 --plan build/cards4/plan4.json
