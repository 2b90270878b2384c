"""Wire-protocol header names of the model server.

The port's copy of `kubeflow_tpu/serve/headers.py`: the same names, so a
client or a front-door router speaks to either package's server alike.
Dependency-free, as the JAX copy is, so a router process can import the
names without the engine stack.
"""

#: End-to-end request budget in milliseconds. The router re-issues it
#: to the replica as the REMAINING budget at forward time — deadline
#: propagation, not per-hop resets.
DEADLINE_HEADER = "X-Request-Timeout-Ms"

#: Trace identity: honored when the caller sets it, assigned otherwise,
#: echoed back, and forwarded replica-ward — one id across the fabric.
REQUEST_ID_HEADER = "X-Request-Id"

#: Marker the replica sets on a drain shed (server.py `_admit`) so the
#: router can tell "draining — retry elsewhere" from "overloaded —
#: forward the backpressure".
DRAINING_HEADER = "X-Tpk-Draining"

#: Router-set response provenance: the replica that served the request
#: (for streams, the FIRST replica — later mid-stream resumes ride the
#: ndjson done frame's `_router` field, since response headers are
#: already on the wire by then) and how many placement attempts the
#: request took.
REPLICA_HEADER = "X-Tpk-Replica"
ATTEMPTS_HEADER = "X-Tpk-Attempts"
