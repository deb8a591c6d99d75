"""Atomic, verifiable, rotated checkpoints.

Counterpart of ``paddle_tpu/checkpoint.py``, with
the same files, manifest and layout, so a checkpoint written by either
package verifies and loads in the other. The contract:

- **atomicity**: a checkpoint is written into a temp dir next to its
  final name, every file is fsynced, a manifest with each file's sha256
  is written last, and the temp dir renames into place. A crash never
  leaves a torn hybrid: a NEW checkpoint name (the rotation manager's
  only case) appears all or nothing; overwriting an existing name has one
  rename-wide window where only that name is absent (older rotations
  still serve ``load_latest``, and the next save sweeps the stranded
  dirs). ``.tmp-`` names are invisible to the rotation scan.
- **verifiability**: ``verify_manifest`` recomputes each listed file's
  sha256; a mismatch or a missing file raises the typed
  ``CheckpointCorrupt``, not a parse error three frames deep.
- **rotation**: ``CheckpointManager`` keeps the newest ``keep``
  checkpoints under ``root/ckpt-<step>/`` with an atomically updated
  ``latest`` pointer; ``load_latest`` walks newest to oldest past corrupt
  entries, so one bad shard costs one checkpoint, not the run.
- **incremental saves**: ``save_incremental`` reuses unchanged shards of
  the previous checkpoint by content hash (or a caller's fingerprint,
  which skips even producing the bytes): a reused shard is hardlinked
  (copied where ``os.link`` fails) instead of re-serialized and
  re-fsynced. Every checkpoint dir stays self-contained.

``io.py``'s var-level saves and inference models use this module's
manifest and atomic writes: there is one copy of that code.

``checkpoint.save_ms`` / ``checkpoint.bytes`` / ``checkpoint.delta_bytes``
/ ``checkpoint.shards_reused`` / ``checkpoint.corrupt`` record into the
observability registry unconditionally, as in the JAX package, and so
does ``checkpoint.round_bytes{mode=}`` of the round-fenced
``RoundStore`` that the parameter server's durable rounds write
(``job_restore_round`` and the job manifest serve the launcher's cold
restart).
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Callable, Dict, List, Optional

from . import observability as _obs
from .observability import flight as _flight

__all__ = ["CheckpointCorrupt", "RestoreMissingShard", "MANIFEST_NAME",
           "SCOPE_VARS_NAME", "ROUND_PREFIX", "JOB_MANIFEST_NAME",
           "atomic_write_bytes", "atomic_checkpoint_dir",
           "makedirs_durable", "write_manifest", "verify_manifest",
           "manifest_extra", "load_scope_snapshot", "RoundStore",
           "job_restore_round", "job_has_durable_state",
           "read_job_manifest", "write_job_manifest", "CheckpointManager",
           "save_checkpoint", "load_checkpoint"]

MANIFEST_NAME = "__manifest__.json"
SCOPE_VARS_NAME = "__vars__.json"  # file name -> var name (snapshots)
_LATEST_NAME = "latest"
_CKPT_PREFIX = "ckpt-"
ROUND_PREFIX = "round-"         # RoundStore frame dirs
_ROUND_BLOB = "blob.bin"        # the frame's concatenated var payload
_OPLOG_NAME = "oplog.jsonl"     # async-mode op tail (RoundStore)
JOB_MANIFEST_NAME = "job.json"  # whole-job restore manifest (launcher)


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed integrity verification (missing file, size or
    sha256 mismatch, unreadable manifest). Callers holding older rotations
    should fall back; callers without one should fail loudly rather than
    train from garbage."""


class RestoreMissingShard(RuntimeError):
    """Whole-job restore needs a round that exists on EVERY shard, and
    this shard contributed none: its durable dir is missing, or every
    round frame in it is torn/corrupt. Names the shard so the operator
    knows which group's disk to recover (a mixed cut must never be
    loaded silently)."""

    def __init__(self, shard: int, root: str, why: str):
        self.shard = int(shard)
        super().__init__(
            "cannot restore the job: shard %d has no usable durable "
            "rounds under %r (%s)" % (self.shard, root, why))


def _observe(name: str, v) -> None:
    _obs.histogram(name).observe(v)


def _count(name: str, n: int = 1, **labels) -> None:
    _obs.counter(name, **labels).inc(n)


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without O_RDONLY dirs; rename is still atomic
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def makedirs_durable(path: str) -> None:
    """``os.makedirs`` whose result survives a HOST crash: every level
    that was actually created gets its parent directory fsynced.
    ``makedirs`` alone only survives process death — the new dirent
    lives in the parent's page cache until the parent is synced, so a
    power cut could erase the directory a checkpoint was just renamed
    into."""
    path = os.path.abspath(path)
    missing = []
    p = path
    while p and not os.path.isdir(p):
        missing.append(p)
        nxt = os.path.dirname(p)
        if nxt == p:
            break
        p = nxt
    os.makedirs(path, exist_ok=True)
    for created in reversed(missing):
        _fsync_dir(os.path.dirname(created))


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` via tmp-file + fsync + rename: the
    file at ``path`` is always either the old content or all of
    ``data``, never a prefix."""
    d = os.path.dirname(os.path.abspath(path))
    makedirs_durable(d)
    # staging name unique per (process, thread, moment): concurrent
    # writers of the SAME path (racing manifest rewrites) must not
    # replace each other's staging file out from under the os.replace
    tmp = os.path.join(d, ".tmp-%s-%d-%d-%d" % (
        os.path.basename(path), os.getpid(),
        threading.get_ident() % 100000, time.monotonic_ns() % 1_000_000))
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(d)


def write_manifest(dirname: str, extra: Optional[Dict] = None,
                   files: Optional[List[str]] = None) -> Dict:
    """Hash files in ``dirname`` into ``__manifest__.json``, written
    atomically LAST — a dir with a valid manifest is a complete dir.
    ``files`` (names relative to ``dirname``) restricts the manifest
    to exactly what a save wrote; the default hashes every regular
    file (dedicated checkpoint dirs) — a save into a SHARED dir must
    pass ``files`` or it would pin unrelated, mutable files and make
    later verification fail spuriously."""
    names = files if files is not None else [
        fn for fn in sorted(os.listdir(dirname))
        if fn != MANIFEST_NAME and not fn.startswith(".tmp-")]
    listed = {}
    for fn in sorted(names):
        p = os.path.join(dirname, fn)
        if not os.path.isfile(p):
            continue
        _fsync_file(p)
        listed[fn] = {"sha256": _sha256(p),
                      "bytes": os.path.getsize(p)}
    doc = {"version": 1, "files": listed}
    if extra:
        doc.update(extra)
    atomic_write_bytes(os.path.join(dirname, MANIFEST_NAME),
                       json.dumps(doc, indent=1, sort_keys=True).encode())
    return doc


def manifest_extra(dirname: str) -> Dict:
    """The caller-supplied ``extra`` a save recorded in ``dirname``'s
    manifest — everything outside the reserved ``version``/``files``
    keys ({} when there is none, or the manifest is unreadable: the
    extra is advisory metadata, e.g. the PS shard map a trainer
    checkpoints so its relaunched incarnation resumes ROUTING from
    the checkpoint instead of rediscovering migrations through
    wrong_shard redirects; never load-bearing for the payload, which
    stays manifest-verified)."""
    try:
        with open(os.path.join(dirname, MANIFEST_NAME), "r",
                  encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    return {k: v for k, v in doc.items()
            if k not in ("version", "files")}


def verify_manifest(dirname: str, required: bool = True) -> Optional[Dict]:
    """Recompute and check every file listed in ``dirname``'s manifest.
    Raises ``CheckpointCorrupt`` on any mismatch; with
    ``required=False`` a missing manifest returns None (pre-manifest
    dirs stay loadable), otherwise it is itself corruption — an atomic
    save always writes one."""
    mpath = os.path.join(dirname, MANIFEST_NAME)
    if not os.path.exists(mpath):
        if not required:
            return None
        raise CheckpointCorrupt(
            "checkpoint dir %r has no %s — it was not written by an "
            "atomic save (or the save never completed)"
            % (dirname, MANIFEST_NAME))
    try:
        with open(mpath, "r", encoding="utf-8") as f:
            doc = json.load(f)
        listed = doc["files"]
    except (ValueError, KeyError, OSError) as e:
        raise CheckpointCorrupt(
            "checkpoint manifest %r is unreadable: %s" % (mpath, e)
        ) from e
    for fn, meta in listed.items():
        p = os.path.join(dirname, fn)
        if not os.path.exists(p):
            raise CheckpointCorrupt(
                "checkpoint %r is missing file %r listed in its "
                "manifest" % (dirname, fn))
        size = os.path.getsize(p)
        if size != int(meta.get("bytes", -1)):
            raise CheckpointCorrupt(
                "checkpoint file %r is %d bytes, manifest says %s"
                % (p, size, meta.get("bytes")))
        digest = _sha256(p)
        if digest != meta.get("sha256"):
            raise CheckpointCorrupt(
                "checkpoint file %r fails sha256 verification "
                "(got %s…, manifest says %s…)"
                % (p, digest[:12], str(meta.get("sha256"))[:12]))
    return doc


def load_scope_snapshot(executor, scope, dirname: str) -> int:
    """Restore a scope snapshot directory (one tensor stream a var, a
    manifest) into ``scope`` after verifying its manifest: a server that
    rejoins must never boot off a torn snapshot, so any integrity failure
    raises the typed ``CheckpointCorrupt`` instead of loading garbage
    params. Var names come from ``__vars__.json`` when present and fall
    back to the file names. ``executor`` is anything with
    ``_write_var(scope, name, value)`` (the op-by-op ``CoreExecutor``);
    values land on its ``device`` (the host where it names none). Returns
    the number of vars restored."""
    from .core import proto_format
    from .core.tensor import from_host_array

    verify_manifest(dirname, required=True)
    vmap_path = os.path.join(dirname, SCOPE_VARS_NAME)
    if os.path.exists(vmap_path):
        with open(vmap_path, "r", encoding="utf-8") as f:
            names = json.load(f)
    else:
        names = {fn: fn for fn in sorted(os.listdir(dirname))
                 if fn not in (MANIFEST_NAME, SCOPE_VARS_NAME)
                 and not fn.startswith(".tmp-")
                 and os.path.isfile(os.path.join(dirname, fn))}
    loaded = 0
    for fn, var in sorted(names.items()):
        with open(os.path.join(dirname, fn), "rb") as f:
            data = f.read()
        arr, _lod, _pos = proto_format.parse_lod_tensor(data)
        executor._write_var(scope, var, from_host_array(
            arr, getattr(executor, "device", None)))
        loaded += 1
    return loaded


@contextlib.contextmanager
def atomic_checkpoint_dir(final_dir: str, extra: Optional[Dict] = None):
    """Context manager: yields a temp dir to write checkpoint files
    into; on clean exit fsyncs everything, writes the manifest, and
    renames the temp dir to ``final_dir`` (replacing any previous
    version only after the new one is durable). On error the temp dir
    is removed and ``final_dir`` is untouched."""
    final_dir = os.path.abspath(final_dir).rstrip(os.sep)
    parent = os.path.dirname(final_dir)
    makedirs_durable(parent)
    # sweep trash a SIGKILLed earlier save stranded (NOT .tmp- dirs: a
    # concurrent save of the same name may be live inside one; tmp
    # leftovers are invisible to scans and merely cost disk)
    base = os.path.basename(final_dir)
    for fn in os.listdir(parent):
        if fn.startswith(base + ".trash-"):
            shutil.rmtree(os.path.join(parent, fn), ignore_errors=True)
    tmp = "%s.tmp-%d-%d" % (final_dir, os.getpid(),
                            time.monotonic_ns() % 1_000_000)
    os.makedirs(tmp)
    t0 = time.monotonic()
    try:
        yield tmp
        doc = write_manifest(tmp, extra=extra)
        _fsync_dir(tmp)
        if os.path.isdir(final_dir):
            # rename-aside + rename-in, not rmtree-then-rename: the
            # no-checkpoint window shrinks to the instant between the
            # two renames (a SIGKILL exactly there costs only THIS
            # name — rotation siblings still serve load_latest; the
            # stranded trash/tmp dirs are swept by the next save)
            trash = "%s.trash-%d-%d" % (final_dir, os.getpid(),
                                        time.monotonic_ns() % 1_000_000)
            os.rename(final_dir, trash)
            os.rename(tmp, final_dir)
            shutil.rmtree(trash, ignore_errors=True)
        else:
            os.rename(tmp, final_dir)
        _fsync_dir(parent)
        total = sum(int(m["bytes"]) for m in doc["files"].values())
        _count("checkpoint.bytes", total)
        _observe("checkpoint.save_ms", (time.monotonic() - t0) * 1e3)
        _flight.record("checkpoint.commit",
                       dir=os.path.basename(final_dir), bytes=total,
                       ms=round((time.monotonic() - t0) * 1e3, 3))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


class CheckpointManager:
    """Keep-last-k rotation under one root::

        root/
          ckpt-42/   __params__.npz  __manifest__.json
          ckpt-43/   ...
          latest     -> "ckpt-43"        (atomically updated pointer)

    ``save`` writes a new numbered checkpoint atomically, repoints
    ``latest``, and prunes beyond ``keep``. ``load_latest`` tries the
    pointer first, then remaining checkpoints newest-to-oldest,
    skipping (and counting) corrupt ones."""

    def __init__(self, root: str, keep: int = 3):
        self.root = os.path.abspath(root)
        self.keep = max(1, int(keep))

    # -- layout ------------------------------------------------------------

    def dir_for(self, step: int) -> str:
        return os.path.join(self.root, "%s%d" % (_CKPT_PREFIX, int(step)))

    def steps(self) -> List[int]:
        """Completed (renamed-into-place) checkpoint steps, ascending;
        temp/trash dirs are invisible by construction."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for fn in os.listdir(self.root):
            if not fn.startswith(_CKPT_PREFIX):
                continue
            tail = fn[len(_CKPT_PREFIX):]
            if tail.isdigit() and os.path.isdir(
                    os.path.join(self.root, fn)):
                out.append(int(tail))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The ``latest`` pointer's step when it names an existing
        checkpoint, else the newest numbered dir, else None."""
        ptr = os.path.join(self.root, _LATEST_NAME)
        try:
            with open(ptr, "r", encoding="utf-8") as f:
                name = f.read().strip()
            tail = name[len(_CKPT_PREFIX):]
            if (name.startswith(_CKPT_PREFIX) and tail.isdigit()
                    and os.path.isdir(os.path.join(self.root, name))):
                return int(tail)
        except OSError:
            pass
        steps = self.steps()
        return steps[-1] if steps else None

    # -- save / load -------------------------------------------------------

    def save(self, step: int, writer: Callable[[str], None],
             extra: Optional[Dict] = None) -> str:
        """Write checkpoint ``step`` atomically: ``writer(tmp_dir)``
        produces the files; manifest + rename + ``latest`` update +
        pruning happen here. Returns the final dir."""
        final = self.dir_for(step)
        meta = {"step": int(step)}
        if extra:
            meta.update(extra)
        with atomic_checkpoint_dir(final, extra=meta) as tmp:
            writer(tmp)
        atomic_write_bytes(os.path.join(self.root, _LATEST_NAME),
                           os.path.basename(final).encode())
        self._prune()
        return final

    def save_incremental(self, step: int, shards: Dict,
                         fingerprints: Optional[Dict[str, str]] = None,
                         extra: Optional[Dict] = None,
                         reuse: str = "link") -> str:
        """Write checkpoint ``step`` reusing unchanged shards from the
        previous checkpoint. ``shards`` maps file name -> bytes or a
        zero-arg callable producing bytes (lazy: never called when the
        shard is fingerprint-matched). A shard is reused — hardlinked
        (``reuse="link"``, the cheap default) or copied
        (``reuse="copy"``) from the previous checkpoint dir — when

        - ``fingerprints[name]`` matches the fingerprint the previous
          manifest recorded for it (the caller's cheap dirty-tracking:
          a version counter, the server's replication digest, ...), or
        - its produced bytes' sha256 matches the previous manifest
          entry (content dedupe — still skips the fresh write+fsync).

        Every dir remains self-contained in its NAMESPACE (loaders and
        ``verify_manifest`` are oblivious), atomic, and rotated as
        usual. Hardlink caveat: reused shards share an inode with the
        previous checkpoint, so in-PLACE corruption of one damages
        both (both detected by their manifests); corruption that
        replaces the file (the common torn-write case) breaks the link
        and costs one checkpoint. Use ``reuse="copy"`` where that
        blast radius matters more than the write savings.

        ``checkpoint.delta_bytes`` counts only the freshly-written
        payload; ``checkpoint.shards_reused`` counts the links — the
        pair is the incremental win, next to the full
        ``checkpoint.bytes``."""
        if reuse not in ("link", "copy"):
            raise ValueError("reuse must be 'link' or 'copy', got %r"
                             % reuse)
        fingerprints = dict(fingerprints or {})
        prev_step = self.latest_step()
        prev_dir = self.dir_for(prev_step) if prev_step is not None \
            else None
        prev_files: Dict = {}
        prev_fps: Dict = {}
        if prev_dir is not None:
            try:
                with open(os.path.join(prev_dir, MANIFEST_NAME),
                          encoding="utf-8") as f:
                    doc = json.load(f)
                prev_files = doc.get("files", {}) or {}
                prev_fps = doc.get("fingerprints", {}) or {}
            except (OSError, ValueError):
                prev_files, prev_fps = {}, {}  # unreadable: full save

        stats = {"reused": 0, "fresh_bytes": 0}

        def _reuse(src: str, dst: str) -> None:
            if reuse == "link":
                try:
                    os.link(src, dst)
                    return
                except OSError:
                    pass  # cross-device / fs without links: fall back
            shutil.copy2(src, dst)

        def writer(tmp: str) -> None:
            for fn in sorted(shards):
                prev_meta = prev_files.get(fn)
                prev_path = (os.path.join(prev_dir, fn)
                             if prev_dir is not None else None)
                have_prev = (prev_meta is not None and prev_path
                             and os.path.isfile(prev_path))
                fp = fingerprints.get(fn)
                if (have_prev and fp is not None
                        and prev_fps.get(fn) == fp):
                    _reuse(prev_path, os.path.join(tmp, fn))
                    stats["reused"] += 1
                    continue
                src = shards[fn]
                data = src() if callable(src) else bytes(src)
                if (have_prev and prev_meta.get("sha256")
                        == hashlib.sha256(data).hexdigest()):
                    _reuse(prev_path, os.path.join(tmp, fn))
                    stats["reused"] += 1
                    continue
                atomic_write_bytes(os.path.join(tmp, fn), data)
                stats["fresh_bytes"] += len(data)

        meta = dict(extra or {})
        meta["fingerprints"] = fingerprints
        final = self.save(step, writer, extra=meta)
        _count("checkpoint.delta_bytes", stats["fresh_bytes"])
        _count("checkpoint.shards_reused", stats["reused"])
        return final

    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir_for(s), ignore_errors=True)

    def load_latest(self, loader: Callable[[str], None]) -> Optional[int]:
        """Verify + load the newest valid checkpoint; walks past
        corrupt ones (counting ``checkpoint.corrupt``) so one bad
        shard falls back to the previous rotation. Returns the loaded
        step, or None when no checkpoint exists. Raises
        ``CheckpointCorrupt`` only when checkpoints exist but ALL fail
        verification."""
        candidates = sorted(self.steps(), reverse=True)
        latest = self.latest_step()
        if latest is not None and latest in candidates:
            candidates.remove(latest)
            candidates.insert(0, latest)
        if not candidates:
            return None
        errors = []
        for step in candidates:
            d = self.dir_for(step)
            try:
                verify_manifest(d, required=True)
                loader(d)
                return step
            except CheckpointCorrupt as e:
                _count("checkpoint.corrupt")
                errors.append(str(e))
                continue
        raise CheckpointCorrupt(
            "every checkpoint under %r failed verification: %s"
            % (self.root, "; ".join(errors)))

    def load_at_or_before(self, step: int,
                          loader: Callable[[str], None]) -> Optional[int]:
        """Like ``load_latest`` but clamped to checkpoints at or below
        ``step`` — the whole-job cold-restart case: the
        launcher's common restore cut can sit BEHIND this process's
        newest checkpoint (a sister shard's newest round was torn and
        the job fell back one round), and resuming ahead of the
        servers would re-drive nothing while the servers wait for
        rounds the trainer thinks already happened. Walks the eligible
        checkpoints newest-to-oldest past corrupt ones; returns the
        loaded step or None when none qualify."""
        step = int(step)
        candidates = [s for s in sorted(self.steps(), reverse=True)
                      if s <= step]
        if not candidates:
            return None
        errors = []
        for s in candidates:
            d = self.dir_for(s)
            try:
                verify_manifest(d, required=True)
                loader(d)
                return s
            except CheckpointCorrupt as e:
                _count("checkpoint.corrupt")
                errors.append(str(e))
                continue
        raise CheckpointCorrupt(
            "every checkpoint at or before step %d under %r failed "
            "verification: %s" % (step, self.root, "; ".join(errors)))


# -- round-fenced durable snapshots -----------------------------------------
#
# Live replication survives the loss of one server of a group; the loss
# of a whole group, or of the whole job, needs state on disk cut at a
# round boundary. ``RoundStore`` keeps, per shard group, the frame the
# primary ships to its backups at each round (full anchors every
# ``PADDLE_PS_ANCHOR_EVERY`` rounds, row or chunk deltas between), in
# the JAX package's layout byte for byte, so either package restores a
# directory the other wrote. ``job_restore_round`` is the newest round
# every shard can restore: never a mixed cut.


class RoundStore:
    """Durable round frames for ONE shard group::

        root/shard-<k>/
          round-41/  blob.bin  __manifest__.json   (mode=full anchor)
          round-42/  blob.bin  __manifest__.json   (mode=delta, base 41)
          oplog.jsonl                              (async op tail)

    Each frame dir is written atomically (manifest last, rename in,
    parent fsynced) with the frame metadata — round, mode, base round,
    fencing epoch, dedup watermark, var headers, and the shard-map /
    migration extras — in the manifest's ``extra``; ``blob.bin`` is
    the concatenated var payload. A frame is *restorable* when its own
    manifest verifies AND (for deltas) its base round is restorable —
    a torn newest frame therefore silently falls back to the previous
    complete round instead of failing restore. Retention keeps the
    newest ``keep_anchors`` anchor chains (fallback needs at least the
    previous one)."""

    def __init__(self, root: str, shard: int = 0,
                 keep_anchors: Optional[int] = None):
        self.root = os.path.abspath(root)
        self.shard = int(shard)
        self.dir = os.path.join(self.root, "shard-%d" % self.shard)
        if keep_anchors is None:
            keep_anchors = int(os.environ.get(
                "PADDLE_PS_DURABLE_KEEP_ANCHORS", "2"))
        self.keep_anchors = max(2, int(keep_anchors))
        self._oplog_path = os.path.join(self.dir, _OPLOG_NAME)
        self._oplog_fp = None
        self._meta_cache: Dict[int, Optional[Dict]] = {}

    # -- layout ------------------------------------------------------------

    def round_dir(self, round_no: int) -> str:
        return os.path.join(self.dir,
                            "%s%d" % (ROUND_PREFIX, int(round_no)))

    def rounds(self) -> List[int]:
        """Renamed-into-place round numbers, ascending (temp/trash
        dirs are invisible by construction)."""
        if not os.path.isdir(self.dir):
            return []
        out = []
        for fn in os.listdir(self.dir):
            if not fn.startswith(ROUND_PREFIX):
                continue
            tail = fn[len(ROUND_PREFIX):]
            if tail.isdigit() and os.path.isdir(
                    os.path.join(self.dir, fn)):
                out.append(int(tail))
        return sorted(out)

    def meta(self, round_no: int) -> Optional[Dict]:
        """Verified frame metadata for ``round_no`` (None when the
        frame is absent, torn, or corrupt). Verification results are
        cached — a frame dir is immutable once renamed into place."""
        round_no = int(round_no)
        if round_no in self._meta_cache:
            return self._meta_cache[round_no]
        d = self.round_dir(round_no)
        meta: Optional[Dict] = None
        try:
            verify_manifest(d, required=True)
            meta = manifest_extra(d)
        except CheckpointCorrupt:
            _count("checkpoint.corrupt")
            meta = None
        self._meta_cache[round_no] = meta
        return meta

    # -- persist -----------------------------------------------------------

    def put_round(self, round_no: int, headers: List[Dict], raw: bytes,
                  watermark: Dict, mode: str = "full",
                  base_round: Optional[int] = None, epoch: int = 0,
                  extra: Optional[Dict] = None) -> str:
        """Persist one applied round's replication frame atomically.
        ``checkpoint.round_bytes{mode=}`` counts the payload — CI
        watches that delta rounds stay a sliver of anchors."""
        meta = {"round": int(round_no), "mode": str(mode),
                "base_round": (-1 if base_round is None
                               else int(base_round)),
                "epoch": int(epoch), "shard": self.shard,
                "watermark": {str(k): int(v)
                              for k, v in (watermark or {}).items()},
                "vars": list(headers)}
        if extra:
            meta["repl_extra"] = extra
        final = self.round_dir(round_no)
        with atomic_checkpoint_dir(final, extra=meta) as tmp:
            atomic_write_bytes(os.path.join(tmp, _ROUND_BLOB), raw)
        self._meta_cache[int(round_no)] = meta
        _count("checkpoint.round_bytes", len(raw), mode=str(mode))
        self._prune()
        return final

    def _prune(self) -> None:
        """Drop frames older than the ``keep_anchors``-newest anchor
        (every kept anchor's delta chain stays whole — restore may
        legitimately fall back to the PREVIOUS chain)."""
        rounds = self.rounds()
        anchors = [r for r in rounds
                   if (self.meta(r) or {}).get("mode") == "full"]
        if len(anchors) <= self.keep_anchors:
            return
        floor = anchors[-self.keep_anchors]
        for r in rounds:
            if r < floor:
                shutil.rmtree(self.round_dir(r), ignore_errors=True)
                self._meta_cache.pop(r, None)

    # -- restore -----------------------------------------------------------

    def restorable_rounds(self) -> List[int]:
        """Rounds whose whole anchor→delta chain verifies, ascending —
        the rounds this shard can contribute to a job-wide cut. A
        delta whose base is missing/corrupt (or whose own frame is
        torn) drops out, along with everything chained past it."""
        good: set = set()
        for r in self.rounds():
            m = self.meta(r)
            if m is None:
                continue
            if m.get("mode") == "full":
                good.add(r)
            elif int(m.get("base_round", -2)) == r - 1 and (r - 1) in good:
                good.add(r)
        return sorted(good)

    def load_round(self, target: int, apply_fn) -> int:
        """Replay the newest anchor chain ending at ``target``:
        ``apply_fn(meta, raw)`` is called for the anchor and every
        delta after it in order, with the same splice semantics a
        replication backup uses. Raises ``CheckpointCorrupt`` when
        ``target`` is not restorable here."""
        target = int(target)
        if target not in set(self.restorable_rounds()):
            raise CheckpointCorrupt(
                "shard %d cannot restore round %d from %r (rounds on "
                "disk: %s)" % (self.shard, target, self.dir,
                               self.rounds()))
        chain = []
        r = target
        while True:
            m = self.meta(r)
            chain.append((r, m))
            if m.get("mode") == "full":
                break
            r -= 1
        for r, m in reversed(chain):
            with open(os.path.join(self.round_dir(r), _ROUND_BLOB),
                      "rb") as f:
                raw = f.read()
            apply_fn(m, raw)
        return target

    # -- async op tail (geo / async mode) ----------------------------------

    def append_op(self, entry: Dict) -> None:
        """Durably append one applied async op (flush + fsync: the op
        was acked to the client — it must survive a whole-job kill).
        ``entry`` carries the op payload plus its dedup token and the
        synthetic round that will fold it (``round``); the tail is
        truncated whenever that round's frame lands."""
        makedirs_durable(self.dir)
        if self._oplog_fp is None:
            self._oplog_fp = open(self._oplog_path, "ab")
        self._oplog_fp.write(
            (json.dumps(entry, sort_keys=True) + "\n").encode())
        self._oplog_fp.flush()
        os.fsync(self._oplog_fp.fileno())

    def clear_ops_through(self, round_no: int) -> None:
        """Drop logged ops folded into round ``round_no``'s frame (they
        are now covered by the frame itself)."""
        keep = [e for e in self.pending_ops()
                if int(e.get("round", 0)) > int(round_no)]
        if self._oplog_fp is not None:
            self._oplog_fp.close()
            self._oplog_fp = None
        if not keep and os.path.exists(self._oplog_path):
            os.unlink(self._oplog_path)
            _fsync_dir(self.dir)
            return
        if keep:
            atomic_write_bytes(
                self._oplog_path,
                b"".join((json.dumps(e, sort_keys=True) + "\n").encode()
                         for e in keep))

    def pending_ops(self, after_round: Optional[int] = None) -> List[Dict]:
        """Logged ops newer than ``after_round`` (all of them when
        None), oldest first; a torn final line (killed mid-append) is
        ignored — that op was never acked durable."""
        out = []
        try:
            with open(self._oplog_path, "rb") as f:
                for line in f:
                    try:
                        e = json.loads(line.decode("utf-8"))
                    except ValueError:
                        continue  # torn tail
                    if after_round is None \
                            or int(e.get("round", 0)) > int(after_round):
                        out.append(e)
        except OSError:
            return []
        return out


def job_restore_round(root: str, expected_shards: int) -> Optional[int]:
    """The newest round restorable on EVERY shard group under
    ``root`` — the only cut a whole-job cold restart may load. Walks
    each shard round-aware (torn newest frames fall out of that
    shard's restorable set, pulling the job cut back with them).
    Raises the typed ``RestoreMissingShard`` — naming the shard — when
    a group's durable dir is missing or holds no complete round; a
    mixed or partial restore must never happen silently. Returns None
    only when no round is common to all shards (shouldn't happen with
    per-round persistence; callers treat it as nothing-to-restore)."""
    common: Optional[set] = None
    for k in range(max(1, int(expected_shards))):
        store = RoundStore(root, k)
        if not os.path.isdir(store.dir):
            raise RestoreMissingShard(
                k, root, "durable dir %r does not exist" % store.dir)
        good = set(store.restorable_rounds())
        if not good:
            raise RestoreMissingShard(
                k, root, "no complete round frame (all torn or corrupt)")
        common = good if common is None else (common & good)
    if not common:
        return None
    return max(common)


def job_has_durable_state(root: str) -> bool:
    """True when ANY shard group left round frames under ``root`` —
    the launcher's restore auto-detect probe (cheap: no verification)."""
    if not root or not os.path.isdir(root):
        return False
    for fn in os.listdir(root):
        d = os.path.join(root, fn)
        if fn.startswith("shard-") and os.path.isdir(d):
            for sub in os.listdir(d):
                if sub.startswith(ROUND_PREFIX) and os.path.isdir(
                        os.path.join(d, sub)):
                    return True
    return False


def read_job_manifest(root: str) -> Dict:
    """The launcher-written ``job.json`` under the durable root ({}
    when absent/unreadable): incarnation counter + the restore cut the
    job booted from."""
    try:
        with open(os.path.join(root, JOB_MANIFEST_NAME), "r",
                  encoding="utf-8") as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else {}
    except (OSError, ValueError):
        return {}


def write_job_manifest(root: str, doc: Dict) -> str:
    path = os.path.join(root, JOB_MANIFEST_NAME)
    atomic_write_bytes(path, json.dumps(
        doc, indent=1, sort_keys=True).encode())
    return path


def save_checkpoint(executor, root: str, step: int, main_program=None,
                    keep: int = 3) -> str:
    """Atomic rotated persistables checkpoint for a static-graph
    program: ``io.save_persistables`` into ``root/ckpt-<step>/`` with
    manifest + ``latest`` pointer; keeps the newest ``keep``."""
    from . import io as _io

    mgr = CheckpointManager(root, keep=keep)
    return mgr.save(step, lambda d: _io.save_persistables(
        executor, d, main_program))


def load_checkpoint(executor, root: str, main_program=None):
    """Load the newest valid checkpoint saved by ``save_checkpoint``;
    returns its step, or None when ``root`` holds none."""
    from . import io as _io

    mgr = CheckpointManager(root)
    return mgr.load_latest(lambda d: _io.load_persistables(
        executor, d, main_program))
