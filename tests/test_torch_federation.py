"""The port's federation (``cook_tpu_torch/federation``, the node's
federation role and ``cook_tpu_torch/sim/federation.py``) against the
JAX package's on the CPU.

Every script runs once on each side, each side's front door over that
side's own cells (``Store.open`` in its own temporary directory, every
server on port 0), and returns a transcript: status codes, JSON bodies,
tokens, exceptions by type and message, ``cell_of_uuid`` of every uuid,
the ``/debug/federation`` panel.  The transcripts must be equal once the
host-clock fields (:data:`CLOCK_KEYS`) are dropped and each side's
server ports are renamed (:func:`norm`).

- the token functions on a seeded sweep of tokens;
- boot validation: ``examples/cook-federation.json``, every bad section,
  ``CellSpec``;
- the single-cell proxy and the two-cell router (the scripts of
  ``tests/test_federation.py``);
- the goodput route mode over three cells of different inventories (the
  port's replays match through K5's plain version on the CPU), and a
  replay whose K5 launch fails, which raises;
- ``run_cell_outage`` at the reference's tier-1 world and at 3 cells:
  the summary, every job's owning cell and every cell's placements;
- the node's federation role.

Job and gang uuids come from ``uuid.uuid4()`` in the client and the
drill; :func:`seeded_uuids` hands both sides one seeded sequence there,
inside the test only.
"""

import dataclasses
import importlib
import json
import os
import random
import re
import sys
import tempfile
import time
import types
import urllib.error
import urllib.request
import uuid as uuid_mod
from contextlib import contextmanager

import pytest
import torch

from test_torch_daemon import fresh_planes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pkg(root):
    ns = types.SimpleNamespace(root=root)
    for name, mod in (("client", "client"), ("cluster", "cluster"),
                      ("config", "config"), ("fed", "federation"),
                      ("tokens", "federation.tokens"),
                      ("rest", "federation.rest"),
                      ("router", "federation.router"),
                      ("api", "rest"), ("sched", "sched"),
                      ("state", "state"),
                      ("simfed", "sim.federation"),
                      ("daemon", "daemon")):
        setattr(ns, name, importlib.import_module(f"{root}.{mod}"))
    return ns


REF, PORT = pkg("cook_tpu"), pkg("cook_tpu_torch")
SIDES = (REF, PORT)


@pytest.fixture(autouse=True)
def _fresh_planes():
    fresh_planes()
    yield
    fresh_planes()


# ----------------------------------------------------------------- harness
#: panel and body fields read off the host's clock
CLOCK_KEYS = {"health_age_s", "staleness_s", "peer_age_s",
              "summary_staleness_s"}
_URL = re.compile(r"http://127\.0\.0\.1:\d+")


def norm(value, ports):
    """``value`` with each of this side's server URLs renamed by its
    place in ``ports`` and the clock fields dropped."""
    if isinstance(value, dict):
        return {k: norm(v, ports) for k, v in value.items()
                if k not in CLOCK_KEYS}
    if isinstance(value, (list, tuple)):
        return [norm(v, ports) for v in value]
    if isinstance(value, str):
        return _URL.sub(lambda m: f"<url{ports.index(m.group(0))}>"
                        if m.group(0) in ports else "<url?>", value)
    return value


def caught(fn):
    """``fn()``'s result, or its exception as (type name, message)."""
    try:
        return ["ok", fn()]
    except Exception as e:  # noqa: BLE001 - the transcript records it
        return ["raised", type(e).__name__, str(e)]


class Side:
    """One package's cells and front doors for a script; every server
    it starts is stopped (or was killed) by :meth:`close`."""

    def __init__(self, p, tmp):
        self.p, self.tmp, self.servers, self.feds = p, tmp, [], []
        self.urls = []
        self.dev = {"device": "cpu"} if p is PORT else {}

    def make_cell(self, name, n_hosts=2, prefix="h", journaled=True,
                  host_res=None):
        p = self.p
        store = (p.state.Store.open(tempfile.mkdtemp(
            prefix=f"{p.root}-{name}-", dir=self.tmp))
            if journaled else p.state.Store())
        store.clock = lambda: 1_700_000_000_000
        res = host_res or (8, 8192)
        cluster = p.cluster.FakeCluster(
            f"{prefix}-cluster",
            [p.cluster.FakeHost(f"{prefix}{i}", p.state.Resources(
                cpus=res[0], mem=res[1])) for i in range(n_hosts)])
        cfg = p.config.Config()
        cfg.default_matcher.backend = "cpu"
        sched = p.sched.Scheduler(store, cfg, [cluster], rank_backend="cpu",
                                  **self.dev)
        api = p.api.CookApi(store, scheduler=sched, config=cfg)
        server = p.api.ApiServer(api)
        server.start()
        self.servers.append(server)
        self.urls.append(server.url)
        return types.SimpleNamespace(store=store, cluster=cluster,
                                     sched=sched, server=server)

    def fed_over(self, cells, **conf):
        section = {"cells": [{"id": cid, "url": cell.server.url, **extra}
                             for cid, cell, extra in cells]}
        section.update(conf)
        node = self.p.rest.build_federation_node(section, **self.dev)
        node.start()
        self.feds.append(node)
        self.urls.append(node.url)
        return node

    def client(self, url, user="alice"):
        return self.p.client.JobClient(url, user=user)

    def close(self):
        for node in self.feds:
            node.stop()
        for server in self.servers:
            try:
                server.stop()
            except Exception:  # noqa: BLE001 - a killed server
                pass


def both(script, tmp_path, *args):
    """``script(side, *args)`` on each package; the normalized
    transcripts, reference first."""
    out = []
    for p in SIDES:
        side = Side(p, tmp_path)
        try:
            got = script(side, *args)
        finally:
            side.close()
        out.append(norm(got, side.urls))
    return out


def U(i):
    return f"00000000-0000-4000-8000-{i:012d}"


def spec(i, **extra):
    return {"uuid": U(i), "command": "x", "cpus": 1, "mem": 64, **extra}


def pinned(i, cell):
    return spec(i, labels={"cell-attribute/cell": cell})


@contextmanager
def seeded_uuids(monkeypatch, p, seed=0):
    """``uuid.uuid4()`` called from ``p``'s client or cell-outage drill
    answers from one seeded sequence; every other caller keeps the
    random one."""
    real = uuid_mod.uuid4
    rng = random.Random(seed)
    callers = {f"{p.root}.client", f"{p.root}.sim.federation"}

    def uuid4():
        if sys._getframe(1).f_globals.get("__name__") in callers:
            return uuid_mod.UUID(int=rng.getrandbits(128), version=4)
        return real()

    monkeypatch.setattr(uuid_mod, "uuid4", uuid4)
    try:
        yield
    finally:
        monkeypatch.setattr(uuid_mod, "uuid4", real)


# ------------------------------------------------------------------ tokens
def _tokens(seed=7, n=80):
    g = random.Random(seed)
    cells = ["cellA", "cellB", "c-3", ""]

    def entry():
        kind = g.randrange(5)
        if kind == 0:
            return str(g.randrange(10_000))
        if kind == 1:
            return f"p{g.randrange(4)}:{g.randrange(5)}:{g.randrange(999)}"
        inner = (str(g.randrange(10_000)) if g.random() < 0.5 else
                 f"p{g.randrange(4)}:{g.randrange(5)}:{g.randrange(999)}")
        if kind == 2:
            return f"{g.choice(cells[:3])}/{inner}"
        if kind == 3:
            return f"{g.choice(cells)}/{inner}" + ("/" if g.random() < .2
                                                   else "")
        return g.choice(["", " ", " cellA/1 ", "/", "cellA/", "/p0:1:2"])

    out = ["", "cellA/p0:3:128", "p0:3:128,p1:3:64", "2372",
           "cellA/p0:3:128,cellB/2372,p1:0:9", "cellB/2372"]
    for _ in range(n):
        out.append(",".join(entry() for _ in range(g.randrange(1, 6))))
    return out


TOKENS = _tokens()
TOKEN_FUNCS = {
    "qualify_token": lambda t, tok: [t.qualify_token(c, tok)
                                     for c in ("cellA", "cellB")],
    "split_entry": lambda t, tok: [list(t.split_entry(e))
                                   for e in tok.split(",")],
    "cells_in_token": lambda t, tok: sorted(t.cells_in_token(tok)),
    "strip_for_cell": lambda t, tok: [
        [r[0], sorted(r[1])] for c in ("cellA", "cellB", "c-3")
        for r in [t.strip_for_cell(tok, c)]],
    "merge_token": lambda t, tok: _merged(t, tok),
    "joined": lambda t, tok: t.joined(_merged(t, tok)),
}


def _merged(t, tok):
    acc = {"cellA/": "1"}
    for c in ("cellA", "cellB"):
        t.merge_token(acc, c, tok)
    return acc


@pytest.mark.parametrize("func", sorted(TOKEN_FUNCS))
def test_token_functions_equal(func):
    f = TOKEN_FUNCS[func]
    for tok in TOKENS:
        assert f(PORT.tokens, tok) == f(REF.tokens, tok), tok
    assert PORT.tokens.CELL_SEP == REF.tokens.CELL_SEP


# ------------------------------------------------------- config and boot
def test_example_federation_conf_boots_the_same():
    conf = json.load(open(os.path.join(REPO, "examples",
                                       "cook-federation.json")))
    got = []
    for p in SIDES:
        node = p.rest.build_federation_node(conf["federation"])
        # never started: boot validation is the point
        router = node.router
        got.append({
            "single_cell": router.single_cell,
            "cells": {cid: dataclasses.asdict(h.spec)
                      for cid, h in router.cells.items()},
            "breakers": {cid: (h.breaker.failure_threshold,
                               h.breaker.reset_timeout_s,
                               h.request_timeout_s)
                         for cid, h in router.cells.items()},
            "config": dataclasses.asdict(
                p.config.FederationConfig.from_conf(conf["federation"]))})
        node.server.server_close()
    assert got[1] == got[0]
    assert got[0]["cells"]["cellB"]["tier"] == "spot"


def _cells(*entries):
    return {"cells": list(entries)}


CELL = {"id": "a", "url": "http://x:1"}
BAD_SECTIONS = {
    "unknown_key": dict(_cells(CELL), tpyo=True),
    "empty_cells": _cells(),
    "cells_not_a_list": {"cells": {"a": CELL}},
    "entry_not_an_object": _cells("a"),
    "unknown_cell_key": _cells(dict(CELL, zone="z")),
    "missing_url": _cells({"id": "a"}),
    "slash_in_id": _cells({"id": "a/b", "url": "http://x:1"}),
    "comma_in_id": _cells({"id": "a,b", "url": "http://x:1"}),
    "ftp_url": _cells({"id": "a", "url": "ftp://x:1"}),
    "weird_tier": _cells(dict(CELL, tier="weird")),
    "attributes_not_an_object": _cells(dict(CELL, attributes=[1])),
    "zero_weight": _cells(dict(CELL, weight=0.0)),
    "duplicate_id": _cells(CELL, {"id": "a", "url": "http://y:1"}),
    "bad_route_mode": dict(_cells(CELL), route_mode="random"),
    "empty_prefix": dict(_cells(CELL), locality_label_prefix=""),
    "negative_age": dict(_cells(CELL), summary_max_age_seconds=-1.0),
    "zero_timeout": dict(_cells(CELL), request_timeout_seconds=0),
    "negative_pending_cap": dict(_cells(CELL), max_user_pending=-1),
    "share_above_one": dict(_cells(CELL), max_user_dominant_share=1.5),
    "zero_spot_penalty": dict(_cells(CELL), spot_penalty=0.0),
    "zero_ledger": dict(_cells(CELL), ledger_max_batches=0),
    "zero_goodput_window": dict(_cells(CELL), goodput_window=0),
}


@pytest.mark.parametrize("name", sorted(BAD_SECTIONS))
def test_bad_section_refused_alike(name):
    got = [caught(lambda: p.rest.build_federation_node(
        BAD_SECTIONS[name], device="cpu") if p is PORT else
        p.rest.build_federation_node(BAD_SECTIONS[name])) for p in SIDES]
    assert got[0][0] == "raised", got[0]
    assert got[1] == got[0]


CELLSPECS = {
    "ok": {"id": "a", "url": "http://x:1", "attributes": {"r": 1},
           "weight": 2},
    "comma": {"id": "a,b", "url": "http://x:1"},
    "slash": {"id": "a/b", "url": "http://x:1"},
    "empty": {"id": "", "url": "http://x:1"},
    "zero_weight": {"id": "a", "url": "http://x:1", "weight": 0.0},
    "bad_url": {"id": "a", "url": "x:1"},
    "bad_tier": {"id": "a", "url": "https://x:1", "tier": "gold"},
    "attributes_list": {"id": "a", "url": "http://x:1", "attributes": []},
}


@pytest.mark.parametrize("name", sorted(CELLSPECS))
def test_cellspec_validation_alike(name):
    got = [caught(lambda: dataclasses.asdict(
        p.fed.CellSpec(**CELLSPECS[name]))) for p in SIDES]
    assert got[1] == got[0]


# -------------------------------------------------------------- one cell
def single_cell_script(s):
    cell = s.make_cell("cell")
    fed = s.fed_over([("solo", cell, {})], max_user_pending=1)
    direct = s.client(cell.server.url)
    routed = s.client(fed.url)
    t = {}
    direct.submit([spec(1, command="echo a")])
    t["direct_token"] = direct.last_commit_offset
    routed.submit([spec(2, command="echo b")])
    t["routed_token"] = routed.last_commit_offset
    # a third submit would trip max_user_pending=1 were the router
    # enforcing globally; a single cell passes through
    t["third"] = caught(lambda: routed.submit([spec(3, command="echo c")]))
    t["routed_job_1"] = routed.job(U(1))
    t["direct_job_2"], t["routed_job_2"] = direct.job(U(2)), routed.job(U(2))
    for path in ("/pools", "/list?user=alice&state=waiting",
                 "/failure_reasons", "/info"):
        a = urllib.request.urlopen(cell.server.url + path).read()
        b = urllib.request.urlopen(fed.url + path).read()
        t[path] = [a == b, json.loads(b)]
    return t


def test_single_cell_proxy_parity(tmp_path):
    ref, port = both(single_cell_script, tmp_path)
    assert port == ref
    assert "/" not in ref["routed_token"]
    assert all(ref[p][0] for p in ("/pools", "/info", "/failure_reasons"))


# ------------------------------------------------------------- two cells
def _duo(s, extra_a=None, extra_b=None, **conf):
    a = s.make_cell("a", prefix="a")
    b = s.make_cell("b", prefix="b")
    fed = s.fed_over([("cellA", a, extra_a or {}),
                      ("cellB", b, extra_b or {})], **conf)
    return a, b, fed


def _owners(fed, n):
    return {U(i): fed.router.cell_of_uuid(U(i)) for i in range(n)}


def _panel(fed):
    doc = json.load(urllib.request.urlopen(fed.url + "/debug/federation"))
    for c in doc["cells"]:
        # the saturation gauges read the cell's own host-clock planes
        c.pop("saturation")
    return doc


def locality_pin(s):
    _a, _b, fed = _duo(s)
    cli = s.client(fed.url)
    cli.submit([pinned(0, "cellB")])
    return {"token": cli.last_commit_offset, "owners": _owners(fed, 2),
            "panel": _panel(fed)}


def attribute_demand(s):
    _a, _b, fed = _duo(s, {"attributes": {"region": "east"}},
                       {"attributes": {"region": "west"}})
    cli = s.client(fed.url)
    cli.submit([spec(0, labels={"cell-attribute/region": "west"})])
    mars = caught(lambda: cli.submit(
        [spec(1, labels={"cell-attribute/region": "mars"})]))
    return {"mars": mars, "owners": _owners(fed, 2), "panel": _panel(fed)}


def global_pending_cap(s):
    _a, _b, fed = _duo(s, max_user_pending=3, summary_max_age_seconds=0.05)
    cli = s.client(fed.url)
    # 2 jobs pinned to each cell: a cell never sees more than 2 pending,
    # only the global merge sees 4
    cli.submit([pinned(0, "cellA"), pinned(1, "cellA")])
    time.sleep(0.06)
    capped = caught(lambda: cli.submit([pinned(2, "cellB"),
                                        pinned(3, "cellB")]))
    # the refusal quotes the staleness window it enforced under
    capped[-1] = re.sub(r"view [0-9.]+s stale", "view <t>s stale",
                        capped[-1])
    other = s.client(fed.url, user="bob")
    other.submit([spec(4)])
    return {"capped": capped, "owners": _owners(fed, 5),
            "token": other.last_commit_offset}


def gang_whole(s):
    _a, _b, fed = _duo(s)
    cli = s.client(fed.url)
    g = U(99)
    cli.submit([spec(i, group=g) for i in range(3)],
               groups=[{"uuid": g, "gang": {"size": 3}}])
    cli.submit([spec(3), spec(4)])
    return {"owners": _owners(fed, 5), "panel": _panel(fed)}


def cross_cell_query(s):
    _a, _b, fed = _duo(s)
    cli = s.client(fed.url)
    cli.submit([pinned(0, "cellA")])
    cli.submit([pinned(1, "cellB")])
    docs = cli.query([U(0), U(1)])
    req = urllib.request.Request(
        f"{fed.url}/jobs/{U(0)}",
        headers={"X-Cook-Min-Offset": cli.last_commit_offset})
    with urllib.request.urlopen(req) as r:
        stale = r.headers["X-Cook-Federation-Stale-Cells"]
        body = json.loads(r.read())
    usage = json.load(urllib.request.urlopen(fed.url + "/usage?user=alice"))
    listed = json.load(urllib.request.urlopen(
        fed.url + "/list?user=alice&state=waiting"))
    return {"docs": docs, "stale": stale, "body": body, "usage": usage,
            "list": sorted(listed, key=lambda d: d["uuid"]),
            "token": cli.last_commit_offset, "owners": _owners(fed, 2),
            "unfederated": caught(lambda: urllib.request.urlopen(
                fed.url + "/queue"))}


def routed_kill_and_retry(s):
    _a, _b, fed = _duo(s)
    cli = s.client(fed.url)
    cli.submit([pinned(0, "cellA"), pinned(1, "cellA")])
    cli.submit([pinned(2, "cellB")])
    out = {"kill": caught(lambda: cli.kill([U(0), U(2)]))}
    out["states"] = [d["state"] for d in cli.query([U(0), U(1), U(2)])]
    out["retry"] = caught(lambda: cli.retry(uuid=U(0), retries=3))
    out["retried"] = [d["state"] for d in cli.query([U(0), U(1), U(2)])]
    out["unknown"] = caught(lambda: cli.job(U(50)))
    out["owners"] = _owners(fed, 3)
    return out


def unreachable_bound(s):
    a = s.make_cell("a", prefix="a")
    b = s.make_cell("b", prefix="b")
    s.client(b.server.url).submit([spec(0)])
    F = s.p.fed
    cells = {"cellA": F.CellHandle(F.CellSpec(id="cellA", url=a.server.url)),
             "cellB": F.CellHandle(F.CellSpec(id="cellB", url=b.server.url))}
    # the reference test's bound is 1.5 s; the kill alone can take a
    # poll interval or two on a loaded worker, so the cached read gets
    # a wider window here
    fs = F.FederatedUserSummaries(cells, max_age_s=3.0)
    fs.refresh()
    out = {"fresh": fs.user_totals("alice")}
    b.server.kill()
    out["cached"] = fs.user_totals("alice")
    time.sleep(3.1)
    out["past_bound"] = caught(lambda: fs.user_totals("alice"))
    out["past_bound"][-1] = re.sub(r"[0-9.]+s", "<t>s", out["past_bound"][-1])
    out["stats"] = {k: v for k, v in fs.stats().items()}
    return out


def never_fetched(s):
    a = s.make_cell("a", prefix="a")
    F = s.p.fed
    cells = {"cellA": F.CellHandle(F.CellSpec(id="cellA", url=a.server.url)),
             "dead": F.CellHandle(F.CellSpec(id="dead",
                                             url="http://127.0.0.1:1"))}
    fs = F.FederatedUserSummaries(cells, max_age_s=0.5)
    got = caught(lambda: fs.user_totals("alice"))
    return [got[0], got[1]]


def drain_rejoin(s):
    _a, _b, fed = _duo(s, summary_max_age_seconds=0.05)
    cli = s.client(fed.url)
    cli.submit([pinned(0, "cellB")])
    router = fed.router
    router.summaries.refresh()
    out = {"before": router.summaries.user_totals("alice")}
    out["drain"] = router.drain_cell("cellB")
    time.sleep(0.06)
    out["drained"] = router.summaries.user_totals("alice")
    out["pick"] = caught(lambda: router.pick_cell(
        {"jobs": [{"labels": {"cell-attribute/cell": "cellB"}}]}).spec.id)
    out["unpinned"] = caught(lambda: cli.submit([spec(1)]))
    out["panel"] = _panel(fed)
    out["rejoin"] = router.rejoin_cell("cellB")
    time.sleep(0.06)
    out["rejoined"] = router.summaries.user_totals("alice")
    out["owners"] = _owners(fed, 2)
    return out


def stale_503(s):
    _a, b, fed = _duo(s, max_user_pending=100, summary_max_age_seconds=0.2)
    cli = s.client(fed.url)
    cli.submit([spec(0)])
    b.server.kill()
    fed.router.cells["cellB"].breaker.trip()
    time.sleep(0.25)
    body = json.dumps({"jobs": [spec(1)]}).encode()
    req = urllib.request.Request(
        fed.url + "/jobs", data=body, method="POST",
        headers={"Content-Type": "application/json", "X-Cook-User": "alice"})
    try:
        urllib.request.urlopen(req)
        got = None
    except urllib.error.HTTPError as e:
        doc = json.loads(e.read())
        doc["error"] = re.sub(r"[0-9.]+s", "<t>s", doc["error"])
        got = [e.code, doc, e.headers.get("Retry-After")]
    health = json.load(urllib.request.urlopen(fed.url + "/debug/health"))
    return {"refused": got, "owners": _owners(fed, 2), "health": health}


def reclaim(s):
    a, _b, fed = _duo(s)
    cli = s.client(fed.url)
    # steer two unpinned batches onto cellA, then kill it and reclaim
    fed.router.drain_cell("cellB")
    cli.submit([spec(0), spec(1)])
    cli.submit([spec(2)])
    fed.router.rejoin_cell("cellB")
    a.server.kill()
    out = {"reclaim": json.load(urllib.request.urlopen(
        urllib.request.Request(fed.url + "/federation/reclaim/cellA",
                               data=b"", method="POST")))}
    out["owners"] = _owners(fed, 3)
    out["read"] = [d["uuid"] for d in cli.query([U(0), U(1), U(2)])]
    out["panel"] = _panel(fed)
    return out


TWO_CELL = {f.__name__: f for f in (
    locality_pin, attribute_demand, global_pending_cap, gang_whole,
    cross_cell_query, routed_kill_and_retry, unreachable_bound,
    never_fetched, drain_rejoin, stale_503, reclaim)}

#: the reference tests' own assertions, held on the transcripts
CLAIMS = {
    "locality_pin": lambda t: t["owners"][U(0)] == "cellB"
    and t["token"].startswith("cellB/"),
    "attribute_demand": lambda t: t["owners"][U(0)] == "cellB"
    and "no eligible cell" in t["mars"][-1],
    "global_pending_cap": lambda t: "pending" in t["capped"][-1]
    and "bound" in t["capped"][-1] and t["owners"][U(4)] is not None,
    "gang_whole": lambda t: len({t["owners"][U(i)] for i in range(3)}) == 1,
    "cross_cell_query": lambda t: t["stale"] == "cellB"
    and {d["uuid"] for d in t["docs"]} == {U(0), U(1)},
    "routed_kill_and_retry": lambda t: t["states"] == ["failed", "waiting",
                                                       "failed"]
    and t["retry"][0] == "ok" and t["retry"][1]["retries"] == 3
    and t["unknown"][2].startswith("HTTP 404"),
    "unreachable_bound": lambda t: t["fresh"]["pending"] == 1.0
    and t["cached"]["pending"] == 1.0
    and t["past_bound"][1] == "SummaryStalenessError",
    "never_fetched": lambda t: t == ["raised", "SummaryStalenessError"],
    "drain_rejoin": lambda t: t["before"]["pending"] == 1.0
    and t["drained"]["pending"] == 0.0 and t["rejoined"]["pending"] == 2.0
    and t["pick"][0] == "raised",
    "stale_503": lambda t: t["refused"][0] == 503
    and t["refused"][1]["reason"] == "summary-stale" and t["refused"][2],
    "reclaim": lambda t: t["reclaim"]["mea_culpa"]
    and t["reclaim"]["reason"] == "cell-reclaimed"
    and {t["owners"][U(i)] for i in range(3)} == {"cellB"},
}


@pytest.mark.parametrize("name", sorted(TWO_CELL))
def test_two_cell_script_parity(name, tmp_path):
    ref, port = both(TWO_CELL[name], tmp_path)
    assert port == ref
    assert CLAIMS[name](ref), ref


# ----------------------------------------------------------------- goodput
GOODPUT_CELLS = (("cellA", 4, (8, 8192)), ("cellB", 2, (16, 4096)),
                 ("cellC", 6, (4, 2048)))
GOODPUT_BATCHES = 24


def goodput_script(s, n_batches=GOODPUT_BATCHES, seed=5):
    cells = [(cid, s.make_cell(cid, n_hosts=n, prefix=cid, host_res=r), {})
             for cid, n, r in GOODPUT_CELLS]
    fed = s.fed_over(cells, route_mode="goodput", goodput_window=12)
    g = random.Random(seed)
    clients = [s.client(fed.url, user=f"u{i}") for i in range(3)]
    picks = []
    for b in range(n_batches):
        n = g.randrange(1, 4)
        specs = [spec(100 * b + j, cpus=g.choice([1, 2, 4, 6]),
                      mem=g.choice([256, 1024, 3000]),
                      labels={"sim/duration_ms": str(g.randrange(1, 20)
                                                     * 1000)})
                 for j in range(n)]
        clients[b % 3].submit(specs)
        picks.append(fed.router.cell_of_uuid(U(100 * b)))
    return {"picks": picks, "panel": _panel(fed)}


def test_goodput_picks_equal(tmp_path):
    ref, port = both(goodput_script, tmp_path)
    assert port == ref
    # the inventories differ enough that more than one cell is picked
    assert len(set(ref["picks"])) > 1


def _goodput_duo(s):
    cells = [(cid, s.make_cell(cid, n_hosts=n, prefix=cid, host_res=r), {})
             for cid, n, r in GOODPUT_CELLS[:2]]
    fed = s.fed_over(cells, route_mode="goodput")
    s.client(fed.url).submit([spec(0)])
    return fed


def test_goodput_replay_failing_on_the_device_raises(tmp_path, monkeypatch):
    """A replay whose K5 launch fails raises out of ``pick_cell``: the
    candidate is not scored 0 and routed around."""
    side = Side(PORT, tmp_path)
    try:
        fed = _goodput_duo(side)
        before = fed.router.pick_cell({"jobs": [spec(1)]}).spec.id
        matcher = importlib.import_module("cook_tpu_torch.sched.matcher")

        def failed_launch(*args, **kw):
            raise RuntimeError("K5 launch failed")

        monkeypatch.setattr(matcher, "_run_kernel", failed_launch)
        with pytest.raises(RuntimeError, match="K5 launch failed"):
            fed.router.pick_cell({"jobs": [spec(1)]})
        # through the front door the batch is refused, not routed
        with pytest.raises(Exception, match="500"):
            side.client(fed.url).submit([spec(2)])
        assert fed.router.cell_of_uuid(U(2)) is None
        monkeypatch.undo()
        assert fed.router.pick_cell({"jobs": [spec(1)]}).spec.id == before
    finally:
        side.close()


def malformed_inventory(s):
    fed = _goodput_duo(s)
    # a host without a name (KeyError), a capacity that is no number
    # (ValueError)
    for h, bad in zip(fed.router.cells.values(),
                      ([{"cpus": 4}], [{"hostname": "x", "cpus": "many"}])):
        h._health["federation_hosts"] = bad
    return [fed.router._goodput_scores(list(fed.router.cells.values())),
            fed.router.pick_cell({"jobs": [spec(1)]}).spec.id]


def test_goodput_skips_a_malformed_inventory_alike(tmp_path):
    ref, port = both(malformed_inventory, tmp_path)
    assert port == ref and ref[0] == {}


# ------------------------------------------------------------ cell outage
def outage_run(p, monkeypatch, **config):
    """``run_cell_outage`` of ``p`` under the seeded uuids: its summary,
    every ledgered job's owning cell, and every cell's jobs with their
    state and hosts (task ids are random)."""
    made, nodes = [], []
    make, build = p.simfed._make_cell, p.rest.build_federation_node

    def make_cell(*args, **kw):
        made.append(make(*args, **kw))
        return made[-1]

    def build_node(*args, **kw):
        nodes.append(build(*args, **kw))
        return nodes[-1]

    monkeypatch.setattr(p.simfed, "_make_cell", make_cell)
    monkeypatch.setattr(p.rest, "build_federation_node", build_node)
    dev = {"device": "cpu"} if p is PORT else {}
    with seeded_uuids(monkeypatch, p, seed=11):
        res = p.simfed.run_cell_outage(
            p.simfed.CellOutageConfig(**config), **dev)
    monkeypatch.setattr(p.simfed, "_make_cell", make)
    monkeypatch.setattr(p.rest, "build_federation_node", build)
    router = nodes[0].router
    owners = {u: router.cell_of_uuid(u) for u in router._uuid_to_batch}
    placed = {}
    for cell in made:
        store = cell.store
        placed[cell.cell_id] = sorted(
            (j.uuid, j.state.value, tuple(
                (i.hostname, i.status.value) for t in j.instances
                if (i := store.instance(t)) is not None))
            for j in store.jobs_where(lambda j: True))
    return {"summary": res.summary(), "owners": owners, "placed": placed}


@pytest.mark.parametrize("n_cells", [2, 3])
def test_cell_outage_equal(n_cells, monkeypatch):
    ref = outage_run(REF, monkeypatch, n_batches=8, n_cells=n_cells)
    port = outage_run(PORT, monkeypatch, n_batches=8, n_cells=n_cells)
    assert port["summary"] == ref["summary"]
    assert port["owners"] == ref["owners"]
    assert port["placed"] == ref["placed"]
    s = ref["summary"]
    assert s["ok"] and s["lost_jobs"] == 0 and s["split_gangs"] == 0
    assert s["rerouted_batches"] > 0 and s["running_after"] > 0
    assert len(ref["owners"]) == s["jobs_acked"]


def test_cell_outage_default_device_refused_before_any_cell(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")

    def no_cell(*args, **kw):
        raise AssertionError("a cell was made")

    monkeypatch.setattr(PORT.simfed, "_make_cell", no_cell)
    monkeypatch.setattr(PORT.simfed.tempfile, "mkdtemp", no_cell)
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        PORT.simfed.run_cell_outage(PORT.simfed.CellOutageConfig())


def test_router_device_is_resolved_only_in_goodput_mode():
    cfg = PORT.config.FederationConfig.from_conf(
        {"cells": [CELL], "route_mode": "load"})
    assert PORT.router.FederationRouter(cfg).device is None
    good = PORT.config.FederationConfig.from_conf(
        {"cells": [CELL], "route_mode": "goodput"})
    assert PORT.router.FederationRouter(good, device="cpu").device == \
        torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda is not"):
            PORT.router.FederationRouter(good)


# ------------------------------------------------------------------- node
ONE_CELL = {"cells": [{"id": "a", "url": "http://127.0.0.1:1"}]}


def node_panel(p, conf, **kw):
    d = p.daemon.CookDaemon(conf, **kw)
    d.start()
    try:
        assert d.federation is not None
        assert d.store is None and d.elector is None and d.server is None
        doc = json.load(urllib.request.urlopen(
            d.node_url + "/debug/federation"))
        info = json.load(urllib.request.urlopen(d.node_url + "/info")) \
            if len(conf["federation"]["cells"]) > 1 else None
    finally:
        d.shutdown()
    assert d.federation is None
    return norm([doc, info], [])


TWO_DEAD = {"cells": [{"id": "a", "url": "http://127.0.0.1:1"},
                      {"id": "b", "url": "http://127.0.0.1:2",
                       "tier": "spot"}],
            "max_user_pending": 10}


@pytest.mark.parametrize("section", ["one_cell", "two_cells"])
def test_daemon_federation_role_serves_the_reference_panel(section):
    fed = {"one_cell": ONE_CELL, "two_cells": TWO_DEAD}[section]
    ref = node_panel(REF, {"federation": fed})
    port = node_panel(PORT, {"federation": fed}, device="cpu")
    assert port == ref
    # a load-mode front door touches no device: the default boots anywhere
    assert node_panel(PORT, {"federation": fed}) == ref


CLASHES = {
    "scheduler": {"scheduler": {"rank_backend": "cpu"}},
    "clusters_and_data_dir": {"clusters": [{"factory": "x"}],
                              "data_dir": "/nonexistent"},
    "replication_election": {"replication": {"sync": True},
                             "election": {"mode": "file"},
                             "election_dir": "/nonexistent"},
    "shared_data_dir": {"shared_data_dir": "/nonexistent"},
}


@pytest.mark.parametrize("name", sorted(CLASHES))
def test_daemon_refuses_federation_plus_cell_state_alike(name):
    got = []
    for p in SIDES:
        d = p.daemon.CookDaemon({"federation": ONE_CELL, **CLASHES[name]},
                                **({"device": "cpu"} if p is PORT else {}))
        got.append(caught(d.start))
        assert d.federation is None and d.server is None
    assert got[0][:2] == ["raised", "ValueError"]
    assert got[1] == got[0]


def test_daemon_goodput_role_without_a_card_fails_the_boot():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    d = PORT.daemon.CookDaemon(
        {"federation": dict(ONE_CELL, route_mode="goodput")})
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        d.start()
    assert d.federation is None
