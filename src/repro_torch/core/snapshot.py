"""⑩ Warm server snapshot and restore (``repro.core.snapshot`` counterpart).

A warmed ``ColdStartServer`` holds state that took real traffic to learn:
which tier-1 units are RESIDENT, in what LRU order, and what the prefetch
predictor knows about unit → unit transitions. A new replica joining a
scaled-out deployment would pay all of that again as request-path faults.
This module writes exactly that state as small, plain JSON, no tensor
bytes, so a new replica can be RESIDENT-warm before it admits traffic:

  * ``capture(tiered, ...)`` → a dict with the resident set and its logical
    LRU stamps, the predictor's ranked tables, and the artifact's identity
    (a fingerprint of the artifact directory's file names and sizes and its
    JSON manifests);
  * ``restore(tiered, snap, ...)`` checks the fingerprint (the weights come
    from the artifact, so a snapshot means something only against the same
    artifact), faults the resident set in again oldest first through the
    ordinary ``ensure`` path (the budget, eviction and a ``HostArbiter``'s
    make-room charges all apply as for organic traffic), puts the donor's
    LRU stamps back and arms the prefetcher's predictor.

Restore is a replay against the restoring replica's own artifact and
budget: a tighter replica keeps the hottest (newest-stamped) suffix of the
donor's resident set, and a unit key it does not own is skipped, never an
error. Wired into ``cold_start(restore_from=...)``, the launcher's
``--snapshot-out`` / ``--restore-from``, and ``FleetController.register``
(the bootstrap fast path).

Locks: ``restore`` calls ``ensure`` once per unit holding no lock (each
``ensure`` takes the arbiter's make-room path, then ``gate``, then the
residency lock, in that order), and takes only the residency lock
(``tiered._lock``) to put the stamps back. It never holds ``gate``.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

from repro_torch.core.prefetch import TransitionPredictor

SNAPSHOT_VERSION = 1


def artifact_fingerprint(artifact_dir: str) -> str:
    """Identity of an artifact directory: sha256 over every file's relative
    path and size, plus the content of its JSON manifests, walked in sorted
    order. Two directories that disagree here hold different artifacts, and
    a snapshot must not cross that line."""
    h = hashlib.sha256()
    for root, dirs, files in os.walk(artifact_dir):
        dirs.sort()
        for fn in sorted(files):
            p = os.path.join(root, fn)
            h.update(os.path.relpath(p, artifact_dir).encode())
            h.update(str(os.path.getsize(p)).encode())
            if fn.endswith(".json"):
                with open(p, "rb") as f:
                    h.update(f.read())
    return h.hexdigest()


def capture(tiered, *, prefetcher=None, artifact_dir: Optional[str] = None) -> dict:
    """A warmed loader's residency state (and the prefetcher's predictor,
    when it has one) as a plain-JSON dict. The resident list is sorted by
    (stamp, key), the order eviction uses, so capture → save → load →
    capture gives the same bytes."""
    with tiered._lock:
        res = tiered.residency
        resident = sorted((res._stamp.get(k, 0), k) for k in res._lru)
        snap = {
            "version": SNAPSHOT_VERSION,
            "artifact": {
                "dir": artifact_dir,
                "fingerprint": artifact_fingerprint(artifact_dir) if artifact_dir else None,
            },
            "clock": res._clock,
            "resident": [[k, stamp] for stamp, k in resident],
        }
    predictor = getattr(prefetcher, "predictor", None)
    snap["predictor"] = predictor.to_dict() if predictor is not None else None
    return snap


def restore(tiered, snap: dict, *, prefetcher=None, artifact_dir: Optional[str] = None,
            strict: bool = True) -> dict:
    """Replay a snapshot onto a fresh loader; returns a report dict
    (``requested``, ``restored``, ``skipped_foreign``, ``moved_bytes``,
    ``fingerprint_ok``, ``predictor_armed``).

    Where both the snapshot and the caller name an artifact, the two must
    match: ``strict=True`` raises on a mismatch, ``strict=False`` skips the
    residency replay (a cold join) and says so in the report. A version
    mismatch always raises.

    Units are faulted oldest stamp first, one ``ensure([k],
    source="preload")`` each, so the restoring replica's own budget or
    arbiter decides what stays: under a tighter budget the oldest restored
    units are the LRU victims. The donor's stamps are then put back on the
    survivors, so the restored replica's first evictions fall on the units
    the donor's would have."""
    version = snap.get("version")
    if version != SNAPSHOT_VERSION:
        raise ValueError(f"unsupported server snapshot version {version!r} (expected {SNAPSHOT_VERSION})")
    report = {
        "requested": len(snap.get("resident", [])),
        "restored": 0,
        "skipped_foreign": 0,
        "moved_bytes": 0,
        "fingerprint_ok": None,
        "predictor_armed": False,
    }
    want = snap.get("artifact", {}).get("fingerprint")
    if want is not None and artifact_dir is not None:
        have = artifact_fingerprint(artifact_dir)
        report["fingerprint_ok"] = have == want
        if have != want:
            if strict:
                raise ValueError(
                    f"snapshot artifact fingerprint mismatch: snapshot has {want[:12]}…, {artifact_dir!r} has "
                    f"{have[:12]}… — a warm snapshot only restores against the same artifact")
            return report  # cold join: the residency replay is skipped

    entries = [(k, stamp) for k, stamp in snap.get("resident", []) if k in tiered._all_units]
    report["skipped_foreign"] = report["requested"] - len(entries)
    # oldest first, one ensure a unit: a batch would share one LRU stamp and
    # load in store-offset order, so only a per-unit replay makes the budget
    # shed exactly the donor's coldest units
    entries.sort(key=lambda ks: (ks[1], ks[0]))
    if entries:
        moved = 0
        for k, _ in entries:
            moved += tiered.ensure([k], source="preload")
        report["moved_bytes"] = moved
        with tiered._lock:
            res = tiered.residency
            stamps = dict(entries)
            survivors = [k for k, _ in entries if k in res._lru]
            for k in survivors:
                res._stamp[k] = stamps[k]
            # recency order to match the stamps put back (other residents,
            # a preloaded hot set, keep theirs and sort in by the same rule)
            for k in sorted(res._lru, key=lambda k: (res._stamp.get(k, 0), k)):
                res._lru.move_to_end(k)
            res._clock = max(res._clock, int(snap.get("clock", 0)))
            report["restored"] = len(survivors)

    if prefetcher is not None and snap.get("predictor") is not None:
        prefetcher.predictor = TransitionPredictor.from_dict(snap["predictor"])
        report["predictor_armed"] = True
    return report


def save(snap: dict, path: str) -> None:
    """Write through ``path + ".partial"`` and a rename (the artifact commit rule)."""
    tmp = path + ".partial"
    with open(tmp, "w") as f:
        json.dump(snap, f, sort_keys=True)
    os.replace(tmp, path)


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
