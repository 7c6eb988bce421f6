"""Beat phases the port's workloads report — the port's copy of the
training, checkpoint and serving subsets of
``kubeflow_controller_tpu/obs/phases.py``.

The values must stay equal to the reference's: the controller's stall
detector and goodput ledger key on these strings (a replica holds its
frozen-step deadline while it beats compile, restore, reshard or a
serving phase).
"""

from __future__ import annotations

PHASE_RENDEZVOUS = "rendezvous"   # process-group join
PHASE_INIT = "init"               # pre-step setup after rendezvous
PHASE_COMPILE = "compile"         # kernel build (the port's compile)
PHASE_FIT = "fit"                 # training step loop — THE goodput phase
PHASE_RESTORE = "restore"         # checkpoint restore on (re)start
PHASE_RESHARD = "reshard"         # restore at another gang width
PHASE_LOAD = "load"               # serving model load
PHASE_SERVING = "serving"         # serving decode loop — serving goodput
PHASE_DRAIN = "drain"             # serving graceful drain
