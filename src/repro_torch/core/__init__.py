# Layering (mirrors repro/core; DESIGN.md §3, §11):
#   geometry/synth/cells  — host-side map + index construction (numpy)
#   compact/resolve       — the device-side resolution core
#   simple/fast           — the paper's two strategies
#   registry/strategies   — Strategy protocol + the registered plugins
#                           (simple | fast | fast_onepass | hybrid |
#                           sharded)
#   artifact              — GeoIndexSet: indices + edge pools, save/load
#   plan                  — the auto-planner behind strategy="auto"
#   engine                — the plan-and-execute GeoEngine facade
#   distributed/enrich    — sharded lookup internals, pipeline operator
