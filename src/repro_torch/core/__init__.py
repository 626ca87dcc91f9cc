# Layering (mirrors repro/core; DESIGN.md §3, §11):
#   geometry/synth/cells  — host-side map + index construction (numpy)
#   compact/resolve       — the device-side resolution core
#   fast                  — the paper's fast (cell index) strategy
#   registry/strategies   — Strategy protocol + the registered plugins
#                           (fast | fast_onepass)
#   artifact              — GeoIndexSet: indices + edge pools, in memory
#   plan                  — the auto-planner behind strategy="auto"
#   engine                — the plan-and-execute GeoEngine facade
