"""The port's copy of ``cook_tpu/sched/constraints.py`` (imports re-rooted).

Constraint compiler: the reference's constraint zoo lowered to a bool[J, H]
mask consumed by the match kernels.

The reference evaluates constraints as host predicates one task at a time
inside Fenzo (reference: scheduler/src/cook/scheduler/constraints.clj —
JobConstraint protocol :51, registry :459, fenzoized :466).  Here the common
constraints are *vectorized* over the jobs x hosts plane up front, which is
what lets the matcher stay a single jitted kernel (SURVEY.md section 7
"constraint extensibility on device"); anything truly dynamic (within-batch
group placement) is validated host-side post-match.

Implemented (reference locations):
  novel-host            constraints.clj:68   — never retry on a host that failed this job
  gpu-host              constraints.clj:122  — gpu jobs only on matching-gpu hosts, and
                                               non-gpu jobs never on gpu hosts
  disk-host             constraints.clj:164  — disk-type affinity
  user attribute EQUALS constraints.clj:356
  max-tasks-per-host    constraints.clj:433
  rebalancer-reservation constraints.clj:242 — reserved hosts only for their job
  checkpoint-locality   constraints.clj:218  — restarted checkpointed jobs pinned
                                               to their previous location attribute
  estimated-completion  constraints.clj:385  — don't place a job on a host
                                               expected to die before the
                                               job's estimated end time
  group unique-host / balanced / attribute-equals (running cotasks)
                        constraints.clj:586-676
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np

from ..cluster.base import Offer
from ..state.schema import (
    DISK_TYPE_LABEL,
    GPU_MODEL_LABEL,
    GroupPlacementType,
    Job,
)

LOCATION_ATTRIBUTE = "location"

# Topology coordinates hosts advertise for gang scheduling (docs/GANG.md):
# the slice a host belongs to and its position within it.  Gang groups
# request co-location by naming an attribute — usually SLICE_ATTRIBUTE —
# whose value must be equal across every member's host.
SLICE_ATTRIBUTE = "slice-id"
SLICE_POSITION_ATTRIBUTE = "slice-position"


def member_slots(avail4: np.ndarray, need4: np.ndarray,
                 cap: int) -> np.ndarray:
    """How many copies of a gang member's demand each host can hold,
    capped at ``cap`` (the gang size — more slots than members never
    changes a decision).  avail4 is [H,4] available cpus/mem/gpus/disk,
    need4 the member's [4] demand.  Zero-demand members fit everywhere
    (cap slots per host)."""
    pos = need4 > 0
    if not pos.any():
        return np.full(avail4.shape[0], cap, dtype=np.int64)
    fit = np.floor(avail4[:, pos] / need4[pos]).min(axis=1)
    return np.clip(fit, 0, cap).astype(np.int64)


@dataclass
class ConstraintContext:
    """Host-side facts the compiler needs beyond the job/offer lists."""

    # job uuid -> hostnames where a previous instance of this job failed
    failed_hosts: Dict[str, Set[str]] = field(default_factory=dict)
    # job uuid -> reserved hostname (rebalancer reservations,
    # rebalancer.clj:419-432, consumed at scheduler.clj:645-653)
    reserved_hosts: Dict[str, str] = field(default_factory=dict)
    # group uuid -> hostnames of *running* cotasks, WITH multiplicity (two
    # cotasks on one host count twice for BALANCED frequencies; unique-host
    # membership checks are unaffected). Any iterable works.
    group_running_hosts: Dict[str, List[str]] = field(default_factory=dict)
    # group uuid -> attribute value of running cotasks (attribute-equals)
    group_attr_values: Dict[str, str] = field(default_factory=dict)
    # group uuid -> Group entity (for placement type/attribute)
    groups: Dict[str, object] = field(default_factory=dict)
    # job uuid -> checkpoint location attribute value to pin to
    checkpoint_locations: Dict[str, str] = field(default_factory=dict)
    max_tasks_per_host: Optional[int] = None
    # hostname -> attribute map for hosts NOT in the current offer set
    # (running cotask hosts); offers take precedence
    host_attributes: Dict[str, Dict[str, str]] = field(default_factory=dict)
    # estimated-completion (constraints.clj:385): job uuid -> estimated end
    # time (epoch ms); hosts advertise "host-start-time" (epoch seconds) and
    # die host_lifetime_mins after it
    estimated_end_ms: Dict[str, int] = field(default_factory=dict)
    host_lifetime_mins: Optional[int] = None

    def host_attrs(self, hostname: str,
                   offer_attrs: Dict[str, Dict[str, str]]) -> Dict[str, str]:
        attrs = offer_attrs.get(hostname)
        return attrs if attrs is not None else \
            self.host_attributes.get(hostname, {})


def _balanced_ok(freqs: Dict[Optional[str], int], value: Optional[str],
                 minimum: int) -> bool:
    """balanced-host-placement evaluate (constraints.clj:600-627): placing on
    ``value`` keeps the group's spread over the attribute balanced; forcing
    minim to 0 while fewer than ``minimum`` distinct values are used pushes
    new tasks onto unused values first."""
    if not freqs:
        return True
    target_freq = freqs.get(value)
    if target_freq is None:
        return True
    minim = 0 if minimum > len(freqs) else min(freqs.values())
    maxim = max(freqs.values())
    return minim == maxim or target_freq < maxim


def build_constraint_mask(jobs: List[Job], offers: List[Offer],
                          ctx: ConstraintContext) -> np.ndarray:
    """Compile all active constraints into one bool[J, H] feasibility mask."""
    J, H = len(jobs), len(offers)
    mask = np.ones((J, H), dtype=bool)
    if J == 0 or H == 0:
        return mask

    host_gpu = np.array([o.capacity.gpus > 0 for o in offers], dtype=bool)
    host_gpu_model = np.array([o.gpu_model for o in offers], dtype=object)
    host_disk_type = np.array([o.disk_type for o in offers], dtype=object)
    host_names = [o.hostname for o in offers]
    host_index = {name: h for h, name in enumerate(host_names)}
    host_tasks = np.array([o.task_count for o in offers], dtype=np.int32)
    offer_attrs = {o.hostname: o.attributes for o in offers}

    # Attribute columns and (attr, value) equality masks are shared across
    # jobs; caching keeps the build O(unique-attrs x H) numpy instead of
    # O(J x H) Python (round-1 weak spot #3).
    attr_cols: Dict[str, np.ndarray] = {}
    eq_masks: Dict[tuple, np.ndarray] = {}

    def attr_col(attr: str) -> np.ndarray:
        col = attr_cols.get(attr)
        if col is None:
            col = np.array([o.attributes.get(attr) for o in offers],
                           dtype=object)
            attr_cols[attr] = col
        return col

    def cached_mask(key, compute) -> np.ndarray:
        m = eq_masks.get(key)
        if m is None:
            m = compute()
            eq_masks[key] = m
        return m

    def attr_equals(attr: str, value) -> np.ndarray:
        return cached_mask((attr, value), lambda: attr_col(attr) == value)

    # estimated-completion: epoch-ms each host is expected to die, +inf when
    # it doesn't advertise "host-start-time" (constraints.clj:392-399)
    host_death_ms = np.full(H, np.inf)
    if ctx.host_lifetime_mins is not None:
        for h, o in enumerate(offers):
            start = o.attributes.get("host-start-time")
            if start is not None:
                try:
                    host_death_ms[h] = (float(start) * 1000.0
                                        + ctx.host_lifetime_mins * 60_000.0)
                except (TypeError, ValueError):
                    pass  # unparseable attr: treat the host as immortal

    # hosts reserved for some job are off-limits to every other job;
    # precompute the reserved host indices + owners once
    reserved_idx, reserved_owner = [], []
    for owner_uuid, hname in ctx.reserved_hosts.items():
        h = host_index.get(hname)
        if h is not None:
            reserved_idx.append(h)
            reserved_owner.append(owner_uuid)
    reserved_idx = np.array(reserved_idx, dtype=np.int64)
    reserved_owner = np.array(reserved_owner, dtype=object)

    if ctx.max_tasks_per_host is not None:
        mask &= (host_tasks < ctx.max_tasks_per_host)[None, :]

    # group UNIQUE running-cotask host indices, computed once per group
    unique_group_idx: Dict[str, np.ndarray] = {}
    # gang group uuid -> member row indices (collected in the loop; the
    # topology-contiguity restriction runs after it, see below)
    gang_rows: Dict[str, List[int]] = {}

    for j, job in enumerate(jobs):
        row = mask[j]

        # novel-host: O(|failed|) lookups, not O(H)
        failed = ctx.failed_hosts.get(job.uuid)
        if failed:
            idx = [host_index[n] for n in failed if n in host_index]
            if idx:
                row[idx] = False

        # gpu-host: bidirectional isolation
        if job.resources.gpus > 0:
            row &= host_gpu
            wanted_model = job.labels.get(GPU_MODEL_LABEL)
            if wanted_model:
                row &= cached_mask(
                    ("~gpu-model", wanted_model),
                    lambda: host_gpu_model == wanted_model)
        else:
            row &= ~host_gpu

        # disk-type affinity
        wanted_disk = job.labels.get(DISK_TYPE_LABEL)
        if wanted_disk:
            row &= cached_mask(
                ("~disk-type", wanted_disk),
                lambda: host_disk_type == wanted_disk)

        # user-specified attribute constraints (EQUALS)
        for c in job.constraints:
            if c.operator.upper() == "EQUALS":
                row &= attr_equals(c.attribute, c.pattern)

        # estimated-completion: skip hosts dying before the job would finish
        est_end = ctx.estimated_end_ms.get(job.uuid)
        if est_end is not None and ctx.host_lifetime_mins is not None:
            row &= est_end < host_death_ms

        # checkpoint locality: pin to prior location
        loc = ctx.checkpoint_locations.get(job.uuid)
        if loc:
            row &= attr_equals(LOCATION_ATTRIBUTE, loc)

        # rebalancer reservations: block hosts reserved for OTHER jobs
        if reserved_idx.size:
            blocked = reserved_idx[reserved_owner != job.uuid]
            if blocked.size:
                row[blocked] = False

        # group placement vs RUNNING cotasks (within-batch handled post-match)
        if job.group is not None:
            group = ctx.groups.get(job.group)
            if getattr(group, "gang", False) \
                    and getattr(group, "gang_topology", None):
                gang_rows.setdefault(job.group, []).append(j)
            ptype = getattr(group, "placement_type", None)
            if ptype is GroupPlacementType.UNIQUE:
                idx = unique_group_idx.get(job.group)
                if idx is None:
                    running = ctx.group_running_hosts.get(job.group, ())
                    idx = np.array(
                        sorted({host_index[n] for n in set(running)
                                if n in host_index}), dtype=np.int64)
                    unique_group_idx[job.group] = idx
                if idx.size:
                    row[idx] = False
            elif ptype is GroupPlacementType.ATTRIBUTE_EQUALS:
                attr = getattr(group, "placement_attribute", None)
                if attr:
                    # allowed values: explicit pin, else the attribute values
                    # of hosts already running cotasks (constraints.clj:628)
                    want = ctx.group_attr_values.get(job.group)
                    allowed = {want} if want is not None else {
                        ctx.host_attrs(hn, offer_attrs).get(attr)
                        for hn in ctx.group_running_hosts.get(job.group, ())}
                    allowed.discard(None)
                    if allowed:
                        key = ("~in", job.group, attr)
                        m = eq_masks.get(key)
                        if m is None:
                            col = attr_col(attr)
                            m = np.zeros(H, dtype=bool)
                            for v in allowed:
                                m |= col == v
                            eq_masks[key] = m
                        row &= m
            elif ptype is GroupPlacementType.BALANCED:
                attr = getattr(group, "placement_attribute", None)
                minimum = getattr(group, "placement_minimum", 2) or 2
                if attr:
                    key = ("~balanced", job.group, attr)
                    m = eq_masks.get(key)
                    if m is None:
                        freqs: Dict[Optional[str], int] = {}
                        for hn in ctx.group_running_hosts.get(job.group, ()):
                            v = ctx.host_attrs(hn, offer_attrs).get(attr)
                            freqs[v] = freqs.get(v, 0) + 1
                        if freqs:
                            col = attr_col(attr)
                            ok = {v: _balanced_ok(freqs, v, minimum)
                                  for v in set(col.tolist())}
                            m = np.array([ok[v] for v in col.tolist()],
                                         dtype=bool)
                        else:
                            m = np.ones(H, dtype=bool)
                        eq_masks[key] = m
                    row &= m

    # gang topology-contiguity preference (docs/GANG.md): each gang with
    # a topology request is restricted to the topology domain (slice)
    # that can absorb the most members, so the match kernel packs
    # slice-local by construction — the gang reduction in ops/gang.py
    # then only enforces the invariant instead of fighting scattered
    # placements.  Domains are compared by member SLOT capacity, not
    # host count: the matcher packs several members onto a wide host,
    # so a 2-host slice of big machines may hold the whole gang while a
    # 3-host slice of small ones cannot — an argmax on hosts would
    # hard-pin the gang to the small slice every cycle and starve it.
    # Score = (holds the whole gang?, remaining slot capacity, feasible
    # host count); ties break on the lexicographically smallest value
    # (deterministic).
    # claimed[(attr, value)]: member slots earlier gangs in THIS batch
    # were already steered into a domain — without it, every gang
    # requesting the same attribute would pick the same argmax slice
    # (identical scores, identical tie-break) and deadlock on it while
    # other slices sit idle
    claimed: Dict[tuple, int] = {}
    if gang_rows:
        avail4 = np.array([[o.available.cpus, o.available.mem,
                            o.available.gpus, o.available.disk]
                           for o in offers], dtype=np.float32)
    for guuid, rows in gang_rows.items():
        group = ctx.groups[guuid]
        attr = group.gang_topology
        col = attr_col(attr)
        # ELASTIC gangs with members already RUNNING (the grow path,
        # docs/GANG.md elasticity) are pinned to the topology domain the
        # gang occupies — a grow member landing in a different slice
        # would violate the equality invariant the reduction no longer
        # checks for satisfied gangs.  Rigid gangs never grow, so this
        # is elastic-only and cannot perturb rigid decisions.
        from ..state.schema import gang_is_elastic
        if gang_is_elastic(group):
            run_vals = set()
            for hn in ctx.group_running_hosts.get(guuid, ()):
                h = host_index.get(hn)
                if h is not None:
                    run_vals.add(col[h])
                else:
                    v = ctx.host_attributes.get(hn, {}).get(attr)
                    if v is not None:
                        run_vals.add(v)
            run_vals.discard(None)
            if len(run_vals) == 1:
                mask[rows] &= (col == next(iter(run_vals)))[None, :]
                continue
        # size members by the elementwise-MAX demand across the gang and
        # gate hosts on EVERY member's constraint row: conservative for
        # heterogeneous gangs (may undercount capacity), but a domain
        # scored "holds the whole gang" really does — sizing by one
        # representative member would let a small member's demand pick a
        # domain its bigger sibling can never fit, pinning the gang
        # there every cycle
        need = np.max(np.array(
            [[jobs[j].resources.cpus, jobs[j].resources.mem,
              jobs[j].resources.gpus, jobs[j].resources.disk]
             for j in rows], dtype=np.float32), axis=0)
        slots = member_slots(avail4, need, cap=len(rows))
        feasible = np.logical_and.reduce(mask[rows], axis=0) & (slots > 0)
        values = sorted({v for v in col.tolist() if v is not None})
        best, best_score = None, None
        for v in values:
            dom = feasible & (col == v)
            cap = int(slots[dom].sum()) - claimed.get((attr, v), 0)
            score = (cap >= len(rows), cap, int(dom.sum()))
            if best_score is None or score > best_score:
                best, best_score = v, score
        if best is None:
            # no host advertises the requested attribute: the gang has
            # no topology domain to land in at all
            mask[rows] = False
        else:
            mask[rows] &= (col == best)[None, :]
            claimed[(attr, best)] = claimed.get((attr, best), 0) \
                + len(rows)
    return mask


def validate_group_placement(jobs: List[Job], assignments: np.ndarray,
                             offers: List[Offer],
                             ctx: ConstraintContext) -> np.ndarray:
    """Post-match within-batch group check: for UNIQUE groups, only the first
    (highest-ranked) cotask per host keeps its slot this cycle; for
    ATTRIBUTE_EQUALS with no running cotask yet, the first placed cotask
    fixes the attribute value for the rest of the batch.

    Returns the assignment vector with violators reset to -1 (they retry next
    cycle, like a Fenzo failure would).
    """
    out = assignments.copy()
    offer_attrs = {o.hostname: o.attributes for o in offers}
    group_hosts: Dict[str, Set[str]] = {
        g: set(hs) for g, hs in ctx.group_running_hosts.items()}
    group_attr: Dict[str, str] = dict(ctx.group_attr_values)
    # BALANCED: running attribute-value frequencies, updated as the batch
    # commits placements in rank order
    group_freqs: Dict[str, Dict[Optional[str], int]] = {}
    for g, hns in ctx.group_running_hosts.items():
        group = ctx.groups.get(g)
        if getattr(group, "placement_type", None) is GroupPlacementType.BALANCED:
            attr = getattr(group, "placement_attribute", None)
            if attr:
                freqs = group_freqs.setdefault(g, {})
                for hn in hns:
                    v = ctx.host_attrs(hn, offer_attrs).get(attr)
                    freqs[v] = freqs.get(v, 0) + 1
    for j, job in enumerate(jobs):
        h = int(out[j])
        if h < 0 or job.group is None:
            continue
        group = ctx.groups.get(job.group)
        ptype = getattr(group, "placement_type", None)
        hostname = offers[h].hostname
        if ptype is GroupPlacementType.UNIQUE:
            used = group_hosts.setdefault(job.group, set())
            if hostname in used:
                out[j] = -1
            else:
                used.add(hostname)
        elif ptype is GroupPlacementType.ATTRIBUTE_EQUALS:
            attr = getattr(group, "placement_attribute", None)
            if attr:
                val = offers[h].attributes.get(attr)
                fixed = group_attr.get(job.group)
                if fixed is None:
                    if val is not None:
                        group_attr[job.group] = val
                elif val != fixed:
                    out[j] = -1
        elif ptype is GroupPlacementType.BALANCED:
            attr = getattr(group, "placement_attribute", None)
            minimum = getattr(group, "placement_minimum", 2) or 2
            if attr:
                freqs = group_freqs.setdefault(job.group, {})
                val = offers[h].attributes.get(attr)
                if _balanced_ok(freqs, val, minimum):
                    freqs[val] = freqs.get(val, 0) + 1
                else:
                    out[j] = -1
    return out


# Constraint names follow the reference's Fenzo constraint class names so
# the unscheduled explainer's message table lines up
# (unscheduled.clj constraint-name->message).
def explain_placement_failure(job: Job, offers: List[Offer],
                              ctx: ConstraintContext,
                              avail: Optional[np.ndarray] = None) -> Dict:
    """Per-host failure census for ONE job: which resource dimensions and
    which constraints excluded how many hosts (reference:
    fenzo_utils.clj summarize-placement-failure — Fenzo reports
    AssignmentFailures per host; here each cause is recomputed as a
    vectorized mask over the offer axis).

    Returns {"resources": {dim: host_count}, "constraints": {name: count}}.
    Only called for under-investigation jobs, so host-side numpy is fine.
    """
    H = len(offers)
    out = {"resources": {}, "constraints": {}}
    if H == 0:
        return out
    if avail is None:
        avail = np.array([[o.available.cpus, o.available.mem,
                           o.available.gpus, o.available.disk]
                          for o in offers], dtype=np.float32)
    need = np.array([job.resources.cpus, job.resources.mem,
                     job.resources.gpus, job.resources.disk],
                    dtype=np.float32)
    for d, dim in enumerate(("cpus", "mem", "gpus", "disk")):
        n = int((avail[:, d] < need[d]).sum())
        if n:
            out["resources"][dim] = n

    def count(name: str, bad_mask: np.ndarray) -> None:
        n = int(np.asarray(bad_mask).sum())
        if n:
            out["constraints"][name] = n

    host_names = [o.hostname for o in offers]
    failed = ctx.failed_hosts.get(job.uuid) or set()
    count("novel_host_constraint",
          np.array([h in failed for h in host_names]))
    host_gpu = np.array([o.capacity.gpus > 0 for o in offers])
    if job.resources.gpus > 0:
        count("gpu_host_constraint", ~host_gpu)
        model = job.labels.get(GPU_MODEL_LABEL)
        if model:
            count("gpu_model_constraint",
                  host_gpu & np.array([o.gpu_model != model for o in offers]))
    else:
        count("non_gpu_host_constraint", host_gpu)
    disk = job.labels.get(DISK_TYPE_LABEL)
    if disk:
        count("disk_type_constraint",
              np.array([o.disk_type != disk for o in offers]))
    for c in job.constraints:
        if c.operator.upper() == "EQUALS":
            count(f"user_defined_constraint:{c.attribute}",
                  np.array([o.attributes.get(c.attribute) != c.pattern
                            for o in offers]))
    loc = ctx.checkpoint_locations.get(job.uuid)
    if loc:
        count("checkpoint_locality_constraint",
              np.array([o.attributes.get(LOCATION_ATTRIBUTE) != loc
                        for o in offers]))
    reserved_other = {h for u, h in ctx.reserved_hosts.items()
                      if u != job.uuid}
    count("rebalancer_reservation_constraint",
          np.array([h in reserved_other for h in host_names]))
    if ctx.max_tasks_per_host is not None:
        count("max_tasks_per_host_constraint",
              np.array([o.task_count >= ctx.max_tasks_per_host
                        for o in offers]))
    if job.group is not None:
        group = ctx.groups.get(job.group)
        ptype = getattr(group, "placement_type", None)
        running = ctx.group_running_hosts.get(job.group, ())
        if getattr(group, "gang", False) \
                and getattr(group, "gang_topology", None):
            # hosts outside every topology domain large enough for the
            # whole gang ("no slice of size K satisfies the request") —
            # sized in member SLOTS, matching the chooser: a slice of 2
            # wide hosts that each fit 2 members DOES hold a gang of 3
            attr = group.gang_topology
            size = int(getattr(group, "gang_size", 0) or 0)
            col = np.array([o.attributes.get(attr) for o in offers],
                           dtype=object)
            need4 = np.array([job.resources.cpus, job.resources.mem,
                              job.resources.gpus, job.resources.disk],
                             dtype=np.float32)
            slots = member_slots(avail, need4, cap=max(size, 1))
            ok_hosts = np.zeros(H, dtype=bool)
            for v in {x for x in col.tolist() if x is not None}:
                sel = col == v
                if int(slots[sel].sum()) >= size:
                    ok_hosts |= sel
            count("gang_topology_constraint", ~ok_hosts)
        if ptype is GroupPlacementType.UNIQUE:
            count("unique_host_constraint",
                  np.array([h in set(running) for h in host_names]))
        elif ptype is GroupPlacementType.ATTRIBUTE_EQUALS:
            attr = getattr(group, "placement_attribute", None)
            if attr:
                offer_attrs = {o.hostname: o.attributes for o in offers}
                want = ctx.group_attr_values.get(job.group)
                allowed = {want} if want is not None else {
                    ctx.host_attrs(hn, offer_attrs).get(attr)
                    for hn in running}
                allowed.discard(None)
                if allowed:
                    count("attribute-equals-host-placement-group-constraint",
                          np.array([o.attributes.get(attr) not in allowed
                                    for o in offers]))
        elif ptype is GroupPlacementType.BALANCED:
            attr = getattr(group, "placement_attribute", None)
            minimum = getattr(group, "placement_minimum", 2) or 2
            if attr:
                offer_attrs = {o.hostname: o.attributes for o in offers}
                freqs: Dict[Optional[str], int] = {}
                for hn in running:
                    v = ctx.host_attrs(hn, offer_attrs).get(attr)
                    freqs[v] = freqs.get(v, 0) + 1
                if freqs:
                    count("balanced-host-placement-group-constraint",
                          np.array([not _balanced_ok(
                              freqs, o.attributes.get(attr), minimum)
                              for o in offers]))
    return out
