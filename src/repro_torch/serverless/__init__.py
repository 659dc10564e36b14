"""Serverless invocation subsystem (paper §2 step 8 + Table 3).

The paper executes tens of thousands of modelling tasks per cycle by
fanning them out as serverless actions. This package reproduces that
pipeline — stateless payloads, an aggregating invoker with bounded
in-flight concurrency/retries/straggler backups, warm-container-sticky
workers, and invocation telemetry — behind the same ``run(jobs)``
executor protocol as ``LocalPoolExecutor``/``FleetExecutor``:

* ``payload``   — serializable invocation payloads (refs, never live objects)
* ``storage``   — the object store mediating payloads/results (in-memory
  + filesystem backends; the Lithops storage path)
* ``futures``   — ``ResponseFuture`` + ``wait(ANY|ALL|ALWAYS)`` streaming
* ``invoker``   — ``ServerlessInvoker`` + the ``ServerlessExecutor`` facade
* ``worker``    — the warm container: payload -> private FleetExecutor
* ``backend``   — ``InlineBackend`` (deterministic, in-process) and
  ``ProcessBackend`` (spawned OS workers, storage-mediated wire)
* ``monitor``   — cold/warm starts, queue + execution latency
* ``autoscale`` — telemetry-driven elastic pool (scale out / reap idle)
* ``chaos``     — deterministic fault injection (kill/drop/duplicate/delay)

Use ``Castor.tick(now, executor="serverless")`` or construct
``ServerlessExecutor`` directly for custom backends.
"""
from .autoscale import AutoscalePolicy, Autoscaler
from .backend import (InlineBackend, InvocationBackend, InvocationError,
                      ProcessBackend)
from .chaos import ChaosKill, ChaosPolicy
from .futures import (ALL_COMPLETED, ALWAYS, ANY_COMPLETED, CancelledError,
                      FuturesTimeoutError, ResponseFuture, wait)
from .invoker import ServerlessExecutor, ServerlessInvoker
from .monitor import InvocationMonitor
from .payload import InvocationPayload, InvocationResult, JobRef
from .storage import (FilesystemStorage, InMemoryStorage, StorageBackend,
                      StorageKeyError)

__all__ = ["InlineBackend", "InvocationBackend", "InvocationError",
           "ProcessBackend", "ServerlessExecutor", "ServerlessInvoker",
           "InvocationMonitor", "InvocationPayload", "InvocationResult",
           "JobRef", "StorageBackend", "InMemoryStorage",
           "FilesystemStorage", "StorageKeyError", "ResponseFuture",
           "wait", "ANY_COMPLETED", "ALL_COMPLETED", "ALWAYS",
           "FuturesTimeoutError", "CancelledError", "ChaosPolicy",
           "ChaosKill", "AutoscalePolicy", "Autoscaler"]
