"""Durability subsystem: write-ahead-logged stores + crash-restart
recovery (the paper's traceability claim made crash-proof).

* ``wal``     — checksummed, length-prefixed append-only record codec.
* ``journal`` — group-commit segment log + periodic snapshot/compaction
  over the ``serverless.storage.StorageBackend`` protocol, plus the
  recovery replay that rebuilds a ``Castor`` bitwise from
  snapshot-then-WAL.
* ``chaos``   — control-plane crash points: enumerate every
  record-prefix state of a finished run's log (including torn /
  truncated / corrupted tails) and a crashing storage wrapper for live
  kill -9 simulation.

Entry point: ``Castor.open(path)`` / ``Castor.open(storage=...)``.
"""
from .journal import Journal, load_records, replay_records, snapshot_records
from .wal import decode_records, encode_record, frame_records

__all__ = ["Journal", "load_records", "replay_records", "snapshot_records",
           "decode_records", "encode_record", "frame_records"]
