"""The durable ledger (``spark.shuffle.tpu.failure.ledgerDir``): shuffle
state that survives the process.

* Every map ``commit()`` seals its output under ``<ledgerDir>/
  shuffle_<id>/`` (the spill seal: temp files, fsync, atomic rename) and
  :meth:`ShuffleLedger.record_commit` rewrites the shuffle's
  ``commit.manifest`` — schema, epoch, each map's rows, size row and
  checksums, and the manifest's own crc32 — atomically.
* A manager started on the same directory calls :meth:`ShuffleLedger.
  scan`: each manifest's crc32 and version are checked, and each sealed
  file's length, crc32 and ``.index`` sidecar against its manifest row.
  Intact maps are served again without recompute; a failing map's files
  move to ``<shuffle dir>/quarantine/``, its row leaves the manifest,
  and only that map is staged again.
* ``<ledgerDir>/quarantine_report.json`` (written atomically) names
  every quarantined block.

The manifest is rewritten whole at each commit, so a reader — a scan
racing a dying writer included — sees the last complete commit set,
never a torn row. The on-disk format is the JAX package's
(``sparkucx_tpu/shuffle/durable.py``): either package adopts the other's
directory.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from sparkucx_tpu_torch.shuffle.integrity import (IntegrityRecord,
                                                 crc32_file)
from sparkucx_tpu_torch.utils.atomicio import atomic_write_text
from sparkucx_tpu_torch.utils.logging import get_logger

log = get_logger("shuffle.durable")

MANIFEST_NAME = "commit.manifest"
QUARANTINE_REPORT = "quarantine_report.json"
_MANIFEST_VERSION = 1


def _manifest_crc(doc: Dict) -> int:
    """CRC32 over the canonical JSON of the manifest body (the ``crc32``
    key excluded) — the manifest seals ITSELF the way the 300 B metadata
    record does (meta/segments.py pack_record)."""
    body = {k: v for k, v in doc.items() if k != "crc32"}
    return zlib.crc32(
        json.dumps(body, sort_keys=True).encode()) & 0xFFFFFFFF


@dataclass
class RecoveredShuffle:
    """One shuffle the restart scan validated out of the ledger."""

    shuffle_id: int
    num_maps: int
    num_partitions: int
    partitioner: str
    bounds: Optional[tuple]
    epoch: int                       # the epoch it was committed under
    directory: str
    # map_id -> (IntegrityRecord, sizes row) for every INTACT map
    intact: Dict[int, tuple] = field(default_factory=dict)
    quarantined: List[int] = field(default_factory=list)


class ShuffleLedger:
    """The durable ledger rooted at ``failure.ledgerDir``."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        # informational epoch stamped into manifests; the owning manager
        # keeps it current (commits record the epoch they happened under,
        # recovery re-registers under whatever epoch the new world runs)
        self.epoch = 0
        # parsed-manifest cache: the ledger is the ONLY writer (under
        # _lock), so record_commit need not re-read + re-parse a
        # manifest that grows with every committed map — without it the
        # per-shuffle commit sequence costs O(maps^2) JSON work
        self._docs: Dict[int, Dict] = {}

    # -- paths -------------------------------------------------------------
    def shuffle_dir(self, shuffle_id: int) -> str:
        return os.path.join(self.root, f"shuffle_{shuffle_id}")

    def manifest_path(self, shuffle_id: int) -> str:
        return os.path.join(self.shuffle_dir(shuffle_id), MANIFEST_NAME)

    def quarantine_report_path(self) -> str:
        return os.path.join(self.root, QUARANTINE_REPORT)

    # -- the write side ----------------------------------------------------
    def record_commit(self, entry, map_id: int, sizes: np.ndarray,
                      rec: IntegrityRecord) -> None:
        """Fold one committed map into the shuffle's manifest and
        rewrite it atomically. Called from ``MapOutputWriter.commit``
        AFTER the spill seal and BEFORE the writer reports committed —
        a manifest row implies sealed, checksummed bytes on disk."""
        sid = entry.shuffle_id
        with self._lock:
            doc = self._docs.get(sid)
            if doc is None:
                doc = self._load_manifest(sid)
            if doc is None:
                if os.path.exists(self.manifest_path(sid)):
                    # an EXISTING manifest failed validation (bit rot /
                    # foreign version): rebuilding can only carry THIS
                    # commit forward — the earlier rows are untrusted.
                    # Say so loudly; their sealed files recompute on
                    # restart, which is the safe outcome.
                    log.error(
                        "shuffle %d: on-disk manifest is invalid — "
                        "rebuilding from this commit; earlier maps "
                        "lose restart coverage and will recompute", sid)
                doc = {
                    "version": _MANIFEST_VERSION,
                    "shuffle_id": sid,
                    "num_maps": entry.num_maps,
                    "num_partitions": entry.num_partitions,
                    "partitioner": entry.partitioner,
                    "bounds": list(entry.bounds)
                    if entry.bounds is not None else None,
                    "maps": {},
                }
            doc["epoch"] = int(self.epoch)
            row = rec.to_dict()
            row["sizes"] = [int(x) for x in sizes]
            doc["maps"][str(map_id)] = row
            doc["crc32"] = _manifest_crc(doc)
            self._docs[sid] = doc
            atomic_write_text(self.manifest_path(sid),
                              json.dumps(doc, sort_keys=True))

    def forget(self, shuffle_id: int) -> None:
        """Delete a shuffle's durable state (explicit unregister — the
        removeShuffle analog). stop()/release() deliberately do NOT
        route here."""
        import shutil
        with self._lock:
            self._docs.pop(shuffle_id, None)
        shutil.rmtree(self.shuffle_dir(shuffle_id), ignore_errors=True)

    # -- the read (restart) side -------------------------------------------
    def _load_manifest(self, shuffle_id: int) -> Optional[Dict]:
        path = self.manifest_path(shuffle_id)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        if doc.get("crc32") != _manifest_crc(doc):
            log.error("%s: manifest CRC mismatch — ignoring the whole "
                      "shuffle (recovery must not trust a corrupt "
                      "manifest)", path)
            return None
        if doc.get("version") != _MANIFEST_VERSION:
            # a CRC-valid manifest from a different format generation:
            # recovery degrades to recompute rather than guessing at
            # foreign row layouts (the mixed-version-fleet case)
            log.error("%s: manifest version %r != %d — ignoring the "
                      "shuffle (written by a different release?)",
                      path, doc.get("version"), _MANIFEST_VERSION)
            return None
        return doc

    def _validate_map(self, sid: int, map_id: int,
                      rec: IntegrityRecord) -> Optional[str]:
        """None when the sealed file set matches its manifest row, else
        the reason it does not (the quarantine report line)."""
        d = self.shuffle_dir(sid)
        stem = os.path.join(d, f"shuffle_{sid}_map_{map_id}")
        if rec.rows == 0:
            return None                       # empty output: no files
        for suffix, need_bytes, want_crc in (
                (".keys", rec.keys_bytes, rec.keys_crc),
                (".vals", rec.vals_bytes, rec.vals_crc)):
            path = stem + suffix
            if need_bytes == 0 and suffix == ".vals":
                continue                      # keys-only output
            try:
                got = os.path.getsize(path)
            except OSError:
                return f"{path}: missing"
            if got != need_bytes:
                return (f"{path}: {got} B on disk, manifest declares "
                        f"{need_bytes} B (torn write / truncation)")
            if crc32_file(path) != want_crc:
                return f"{path}: crc32 mismatch vs manifest"
        # the .index sidecar gets CONTENT validation too — open_sealed
        # and load() trust it, so a bit-rotted sidecar must quarantine
        # here, not crash adoption untyped or mis-declare the row count
        try:
            with open(stem + ".index") as f:
                idx = json.load(f)
        except (OSError, ValueError) as e:
            return f"{stem}.index: unreadable sidecar ({e})"
        want_tail = list(rec.val_tail) if rec.val_tail is not None else None
        if (int(idx.get("rows", -1)) != rec.rows
                or idx.get("val_dtype") != rec.val_dtype
                or idx.get("val_tail") != want_tail):
            return (f"{stem}.index: sidecar disagrees with the manifest "
                    f"row (rows/schema mismatch)")
        return None

    def _quarantine_map(self, sid: int, map_id: int, reason: str,
                        report: List[Dict]) -> None:
        """Move a failed block's files aside (they must not be served,
        but an operator may want the evidence) and record it."""
        d = self.shuffle_dir(sid)
        qdir = os.path.join(d, "quarantine")
        os.makedirs(qdir, exist_ok=True)
        stem = f"shuffle_{sid}_map_{map_id}"
        for suffix in (".keys", ".vals", ".index"):
            src = os.path.join(d, stem + suffix)
            if os.path.exists(src):
                dst = os.path.join(qdir, f"{stem}{suffix}.{int(time.time())}")
                try:
                    os.replace(src, dst)
                except OSError:
                    pass
        log.error("ledger quarantined shuffle %d map %d: %s",
                  sid, map_id, reason)
        report.append({"shuffle_id": sid, "map_id": map_id,
                       "reason": reason})

    def scan(self) -> List[RecoveredShuffle]:
        """Validate every shuffle directory under the ledger root.
        Returns the recoverable set (intact maps per shuffle, failing
        maps quarantined) and rewrites the quarantine report when
        anything was quarantined. Never raises — a rotten ledger entry
        degrades to recompute, exactly like no ledger at all."""
        out: List[RecoveredShuffle] = []
        report: List[Dict] = []
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return out
        for name in names:
            if not name.startswith("shuffle_"):
                continue
            try:
                sid = int(name[len("shuffle_"):])
            except ValueError:
                continue
            doc = self._load_manifest(sid)
            if doc is None:
                continue
            try:
                rs = self._scan_shuffle(sid, doc, report)
            except Exception as e:
                # the never-raises contract: any surprise in a single
                # shuffle's rows (foreign fields, malformed sizes)
                # degrades THAT shuffle to recompute, exactly like no
                # ledger at all — it must not fail manager construction
                log.error("ledger scan: shuffle %d unreadable (%s) — "
                          "it will recompute", sid, e)
                continue
            out.append(rs)
            log.warning(
                "ledger scan: shuffle %d — %d/%d maps intact%s", sid,
                len(rs.intact), rs.num_maps,
                f", {len(rs.quarantined)} quarantined"
                if rs.quarantined else "")
        if report:
            self.write_quarantine_report(report)
        return out

    def _scan_shuffle(self, sid: int, doc: Dict,
                      report: List[Dict]) -> RecoveredShuffle:
        """Validate one manifest's rows into a RecoveredShuffle
        (scan()'s per-shuffle body — exceptions degrade that shuffle to
        recompute in the caller)."""
        rs = RecoveredShuffle(
            shuffle_id=sid, num_maps=int(doc["num_maps"]),
            num_partitions=int(doc["num_partitions"]),
            partitioner=doc["partitioner"],
            bounds=tuple(doc["bounds"])
            if doc.get("bounds") is not None else None,
            epoch=int(doc.get("epoch", 0)),
            directory=self.shuffle_dir(sid))
        for mid_s, row in sorted(doc.get("maps", {}).items(),
                                 key=lambda kv: int(kv[0])):
            mid = int(mid_s)
            rec = IntegrityRecord.from_dict(row)
            reason = self._validate_map(sid, mid, rec)
            if reason is None:
                rs.intact[mid] = (
                    rec, np.asarray(row["sizes"], dtype=np.int64))
            else:
                self._quarantine_map(sid, mid, reason, report)
                rs.quarantined.append(mid)
        if rs.quarantined:
            # drop the quarantined rows from the manifest: a SECOND
            # restart before the app re-stages them must not
            # re-quarantine the same (now moved-aside) blocks —
            # counters and the report would inflate with restart
            # count instead of distinct corrupt blocks. A later
            # re-stage commit re-adds the row.
            for mid in rs.quarantined:
                doc["maps"].pop(str(mid), None)
            doc["crc32"] = _manifest_crc(doc)
            with self._lock:
                self._docs[sid] = doc
                atomic_write_text(self.manifest_path(sid),
                                  json.dumps(doc, sort_keys=True))
        return rs

    def write_quarantine_report(self, blocks: List[Dict]) -> str:
        """Merge ``blocks`` into the ledger's quarantine report
        (atomic); returns its path."""
        path = self.quarantine_report_path()
        doc = {"blocks": []}
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            pass
        doc.setdefault("blocks", []).extend(blocks)
        doc["ts"] = time.time()
        atomic_write_text(path, json.dumps(doc, indent=1, sort_keys=True))
        return path
