"""Fleet primitives: heartbeats, leasable shards, work stealing.

The twin of ``repro/streaming/fleet.py``, writing the same lease and
heartbeat files, so either package reads the other's. The sweep grid's
unit of fault tolerance is the shard (a contiguous seed slice of the case x
seed grid, ``core.sweep.slice_seed_shards``), and leases make it
stealable:

* ``LeaseStore`` keeps one JSON lease a shard under ``<workdir>/leases/``:
  a fencing token that every acquisition raises, the owner, renewal stamps
  on two clocks, and the owner history (a stolen shard shows in the resume
  report). Acquisition is write-then-verify: a claimant renames a
  nonce-stamped claim over the lease file and reads it back; the last
  rename wins and the others see a foreign nonce and back off. Two owners
  of one shard can only duplicate work: results are deterministic and
  every checkpoint and publish is an atomic rename. The token fences
  liveness: a victim finds the foreign token at its next chunk-boundary
  renewal and abandons the shard (``LeaseLost``).
* Heartbeats are progress beats: a worker touches
  ``<workdir>/worker_<shard>/heartbeat`` at every chunk boundary (through
  ``CheckpointManager.on_save``), so the launcher can kill a worker that
  is alive but wedged.
* ``fleet_worker_loop`` is the elastic worker: take a shard (a lease it
  already holds first, then a never-leased one, then the stalest expired
  one), run it from the victim's checkpointed sweep state, publish,
  release, repeat until every shard has a published result.
"""
from __future__ import annotations

import json
import os
import time
import uuid
from typing import Dict, List, Optional

from ..obs import get_journal

__all__ = ["LeaseLost", "LeaseStore", "Lease", "touch_heartbeat",
           "heartbeat_age", "read_heartbeat", "fleet_worker_loop"]

_LEASE_DIR = "leases"


class LeaseLost(RuntimeError):
    """Raised at a renewal that finds a foreign fencing token: the shard
    was stolen from us — stop computing it."""


def touch_heartbeat(path: str, step: int = 0) -> None:
    """Atomically (re)write the heartbeat file; staleness is its mtime."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"pid": os.getpid(), "step": int(step),
                   "t": time.time()}, f)
    os.replace(tmp, path)


def heartbeat_age(path: str, now: Optional[float] = None) -> Optional[float]:
    """Seconds since the last beat, or None if no heartbeat exists yet."""
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return None
    return (time.time() if now is None else now) - mtime


def read_heartbeat(path: str) -> Optional[dict]:
    """The heartbeat's JSON payload ({pid, step, t}), or None if absent or
    torn mid-replace. ``touch_heartbeat`` has always written the worker's
    last completed step here — this reader surfaces it so stall-kill and
    stalest-lease diagnostics can say WHERE a silent worker stopped, not
    just how long ago (the mtime)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


class Lease(dict):
    """A lease document (plain dict with typed accessors).

    Leases are stamped with BOTH clocks: ``renewed_at`` (wall) and
    ``renewed_mono`` (``time.monotonic()``). Expiry is computed from the
    monotonic pair whenever it is coherent — ``time.monotonic()`` is
    system-wide per boot, so any process on the same host can age a lease
    against its own monotonic reading, immune to NTP steps and operator
    ``date`` jumps that would make a wall-clock age negative (a live lease
    never expiring) or huge (a live lease instantly stolen). The wall
    stamp is the fallback for leases written by an older code version,
    read across a reboot (a monotonic stamp from a previous boot reads as
    the future — detected and ignored), or read on a different host.
    """

    @property
    def owner(self) -> str:
        return self.get("owner", "")

    @property
    def token(self) -> int:
        return int(self.get("token", 0))

    @property
    def renewed_at(self) -> float:
        return float(self.get("renewed_at", 0.0))

    @property
    def renewed_mono(self) -> Optional[float]:
        v = self.get("renewed_mono")
        return None if v is None else float(v)

    @property
    def owners(self) -> List[str]:
        return list(self.get("owners", []))

    def age(self, now: Optional[float] = None,
            now_mono: Optional[float] = None) -> float:
        """Seconds since the last renewal, from a jump-immune source.

        Prefers the monotonic pair when the stamp is coherent with our
        reading (not from a different boot/host, tolerating sub-second
        cross-process skew); falls back to wall-clock age otherwise."""
        mono = self.renewed_mono
        if mono is not None:
            nm = time.monotonic() if now_mono is None else now_mono
            if nm - mono >= -1.0:              # coherent monotonic pair
                return nm - mono
        return (time.time() if now is None else now) - self.renewed_at

    def expired(self, ttl: float, now: Optional[float] = None,
                now_mono: Optional[float] = None) -> bool:
        return self.age(now, now_mono) > ttl


class LeaseStore:
    """File-backed lease table, one lease per shard (see module docstring).

    All mutations are atomic renames; reads tolerate concurrent writers by
    treating an unreadable lease as absent (the writer will re-verify).
    """

    def __init__(self, workdir: str, ttl: float = 30.0):
        self.workdir = workdir
        self.root = os.path.join(workdir, _LEASE_DIR)
        self.ttl = float(ttl)
        os.makedirs(self.root, exist_ok=True)

    def _victim_step(self, shard: int) -> Optional[int]:
        """Last step the shard's previous owner heartbeat before going
        silent (pinned-layout heartbeat path; None if never beaten)."""
        doc = read_heartbeat(os.path.join(self.workdir, f"worker_{shard}",
                                          "heartbeat"))
        return None if doc is None else doc.get("step")

    def _path(self, shard: int) -> str:
        return os.path.join(self.root, f"shard_{int(shard)}.json")

    def read(self, shard: int) -> Optional[Lease]:
        try:
            with open(self._path(shard)) as f:
                return Lease(json.load(f))
        except (OSError, ValueError):
            return None

    def _write(self, shard: int, doc: dict) -> None:
        tmp = self._path(shard) + f".tmp-{os.getpid()}-{uuid.uuid4().hex[:6]}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(shard))

    def try_acquire(self, shard: int, owner: str) -> Optional[Lease]:
        """Acquire ``shard`` if it is unleased, expired, or already ours.

        Returns the lease we now hold (with a freshly bumped fencing
        token), or None if a live foreign owner holds it or a concurrent
        claimant out-renamed us."""
        now = time.time()
        now_mono = time.monotonic()
        cur = self.read(shard)
        if (cur is not None and cur.owner != owner
                and not cur.expired(self.ttl, now, now_mono)):
            return None
        nonce = uuid.uuid4().hex
        doc = Lease({
            "owner": owner,
            "token": (cur.token + 1) if cur else 1,
            "acquired_at": now,
            "renewed_at": now,
            "renewed_mono": now_mono,
            "nonce": nonce,
            "owners": (cur.owners if cur else []) + [owner],
        })
        self._write(shard, doc)
        got = self.read(shard)
        if got is None or got.get("nonce") != nonce:
            return None                       # out-renamed by another claimant
        stolen_from = (cur.owner if cur is not None and cur.owner
                       and cur.owner != owner else None)
        get_journal().event("lease_acquire", "fleet", shard=shard,
                            token=got.token, stolen_from=stolen_from)
        return got

    def renew(self, shard: int, owner: str, token: int) -> None:
        """Refresh our renewal stamp; raise ``LeaseLost`` on a foreign
        token (the shard was stolen — abandon it)."""
        cur = self.read(shard)
        if cur is None or cur.owner != owner or cur.token != int(token):
            get_journal().event(
                "lease_lost", "fleet", shard=shard, token=int(token),
                holder=cur.owner if cur else None,
                holder_token=cur.token if cur else None)
            raise LeaseLost(f"shard {shard}: lease lost to "
                            f"{cur.owner if cur else '<gone>'}")
        cur["renewed_at"] = time.time()
        cur["renewed_mono"] = time.monotonic()
        self._write(shard, cur)

    def release(self, shard: int, owner: str, token: int,
                done: bool = False) -> None:
        cur = self.read(shard)
        if cur is None or cur.owner != owner or cur.token != int(token):
            return                            # stolen meanwhile — nothing to do
        cur["owner"] = ""
        cur["done"] = bool(done)
        cur["renewed_at"] = 0.0               # immediately acquirable
        cur["renewed_mono"] = None            # (from either clock)
        self._write(shard, cur)
        get_journal().event("lease_release", "fleet", shard=shard,
                            token=int(token), done=bool(done))

    def pick(self, shards: List[int], owner: str) -> Optional[int]:
        """The next shard ``owner`` should take: a shard whose lease we
        ALREADY hold first (reclaiming our own work is always right, and
        the fencing token still protects it if someone stole it meanwhile),
        then a never-leased shard, else the STALEST expired lease (the
        worst straggler's)."""
        now = time.time()
        now_mono = time.monotonic()
        stalest, stalest_age, stalest_owner = None, -1.0, ""
        for s in shards:
            cur = self.read(s)
            if cur is not None and cur.owner == owner:
                return s
        for s in shards:
            cur = self.read(s)
            if cur is None:
                return s
            if cur.expired(self.ttl, now, now_mono):
                age = cur.age(now, now_mono)
                if age > stalest_age:
                    stalest, stalest_age, stalest_owner = s, age, cur.owner
        if stalest is not None and stalest_owner:
            # a steal of a live-owned-but-expired lease: say who the victim
            # was, how stale, and the last step it heartbeat — not just the
            # lease-file age
            step = self._victim_step(stalest)
            print(f"fleet {owner}: picking stalest shard {stalest} from "
                  f"{stalest_owner} (lease {stalest_age:.1f}s stale, last "
                  f"heartbeat step {'?' if step is None else step})")
            get_journal().event("lease_pick", "fleet", shard=stalest,
                                victim=stalest_owner,
                                age_s=round(stalest_age, 3),
                                victim_step=step)
        return stalest

    def snapshot(self) -> Dict[int, Lease]:
        out = {}
        for name in os.listdir(self.root):
            if name.startswith("shard_") and name.endswith(".json"):
                shard = int(name[len("shard_"):-len(".json")])
                lease = self.read(shard)
                if lease is not None:
                    out[shard] = lease
        return out


def fleet_worker_loop(spec: dict, workdir: str, worker_id: str, *,
                      ttl: float, poll: float = 0.2, device=None) -> int:
    """Elastic worker body: steal-and-run shards until all are published
    (on ``device``, the card unless the caller asks for the CPU)."""
    from .._device import resolve_device
    from .launcher import _load_result
    from .worker import run_shard

    device = resolve_device(device)
    store = LeaseStore(workdir, ttl=ttl)
    shards = list(range(len(spec["shards"])))
    ran = 0
    while True:
        pending = [s for s in shards
                   if _load_result(workdir, spec, s, device=device) is None]
        if not pending:
            break
        shard = store.pick(pending, worker_id)
        if shard is None:
            time.sleep(poll)                 # all pending shards live-leased
            continue
        lease = store.try_acquire(shard, worker_id)
        if lease is None:
            time.sleep(poll)
            continue
        try:
            run_shard(spec, workdir, shard, worker=worker_id,
                      lease_store=store, lease=lease, device=device)
            ran += 1
            store.release(shard, worker_id, lease.token, done=True)
        except LeaseLost:
            print(f"fleet {worker_id}: shard {shard} stolen, moving on")
            continue
    print(f"fleet {worker_id}: all shards published ({ran} run here)")
    return 0
