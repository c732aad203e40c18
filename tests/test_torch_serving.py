"""The port's serving layer: the 2-replica WorkStealingFrontend's greedy
token streams against the JAX engine's on a seeded request set, plus the
frontend's and WS-WMULT's own contracts with a model-free batcher."""

import numpy as np
import pytest

from repro_torch.core import EMPTY, WSWMult
from repro_torch.serving import Request, WorkStealingFrontend


class FakeBatcher:
    """Admits up to B requests and finishes each after `latency` steps."""

    def __init__(self, slots=2, latency=2):
        self.B = slots
        self.live = [None] * slots
        self._countdown = [0] * slots
        self.latency = latency

    @property
    def n_live(self):
        return sum(r is not None for r in self.live)

    def admit(self, req):
        for i, r in enumerate(self.live):
            if r is None:
                self.live[i] = req
                self._countdown[i] = self.latency
                req.out.append(int(req.tokens[-1]) + 1)
                return True
        return False

    def step(self):
        done = []
        for i, r in enumerate(self.live):
            if r is None:
                continue
            self._countdown[i] -= 1
            r.out.append(len(r.out))
            if self._countdown[i] <= 0:
                done.append(r)
                self.live[i] = None
        return done


def _req(rid, tok=1):
    return Request(rid=rid, tokens=np.array([tok], dtype=np.int32))


def test_frontend_streams_match_jax_engine():
    jax = pytest.importorskip("jax")
    from repro.configs.llama3_2_3b import SMOKE as J_SMOKE
    from repro.models import init_params as j_init
    from repro.serving.engine import ContinuousBatcher as JBatcher
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import WorkStealingFrontend as JFrontend
    from repro_torch.configs.llama3_2_3b import SMOKE
    from repro_torch.convert import params_from_jax
    from repro_torch.serving import ContinuousBatcher

    jp = j_init(jax.random.PRNGKey(0), J_SMOKE)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, J_SMOKE.vocab_size, (6,)).astype(np.int32) for _ in range(4)]

    def serve(front, req_cls):
        for rid, p in enumerate(prompts):
            front.submit(0, req_cls(rid=rid, tokens=p, max_new=2))
        done = front.run(max_iters=100)
        return {rid: list(r.out) for rid, r in done.items()}, front.stats()["totals"]

    want, jtot = serve(JFrontend(lambda: JBatcher(jp, J_SMOKE, slots=2, capacity=16),
                                 n_replicas=2), JRequest)
    got, ttot = serve(WorkStealingFrontend(
        lambda: ContinuousBatcher(tp, SMOKE, slots=2, capacity=16), n_replicas=2), Request)
    assert got == want
    assert sorted(got) == [0, 1, 2, 3] and all(len(o) == 2 for o in got.values())
    assert ttot["stolen"] == jtot["stolen"] == 2


def test_batcher_rejects_prompts_that_cannot_fit():
    from repro_torch.configs.llama3_2_3b import SMOKE
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatcher

    b = ContinuousBatcher(init_params(SMOKE, seed=0, device="cpu"), SMOKE, slots=1, capacity=8)
    assert not b.admit(Request(0, np.zeros(8, np.int32)))
    assert not b.admit(Request(1, np.zeros(0, np.int32)))
    assert b.admit(Request(2, np.arange(7, dtype=np.int32), max_new=2))
    assert not b.admit(Request(3, np.arange(3, dtype=np.int32)))  # no free slot
    (r,) = b.step()
    assert r.rid == 2 and len(r.out) == 2


def test_duplicate_admission_dedups_on_completion():
    """The §7 interleaving on a request queue: the owner's Take stalls before
    publishing Head, a thief Steals the same request, both replicas admit
    it; exactly one result survives and the duplicate is counted."""
    f = WorkStealingFrontend(lambda: FakeBatcher(), n_replicas=2)
    req = Request(rid=42, tokens=np.array([1, 2, 3], dtype=np.int32), max_new=4)
    f.submit(0, req)
    q = f.queues[0]
    head = max(q._local_head(0), q.Head.read(0))
    taken_by_owner = q.tasks.read(head, 0)
    stolen = q.steal(pid=2)
    assert stolen is taken_by_owner is req
    q.Head.write(head + 1, 0)
    q._head[0] = head + 1
    f.batchers[0].admit(Request(req.rid, req.tokens, req.max_new))
    f.batchers[1].admit(Request(req.rid, req.tokens, req.max_new))
    completed = f.run(max_iters=50)
    assert set(completed) == {42}
    assert f.counters["dup_completed"] == 1
    assert q.take() is EMPTY and q.steal(5) is EMPTY


def test_idle_replica_steals_backlogged_queue():
    f = WorkStealingFrontend(lambda: FakeBatcher(), n_replicas=2)
    for rid in range(8):
        f.submit(0, _req(rid, rid))
    assert set(f.run(max_iters=200)) == set(range(8))
    st = f.stats()
    assert st["totals"]["stolen"] > 0
    assert st["per_replica"][1]["stolen"] == st["totals"]["stolen"]
    assert st["per_replica"][0]["submitted"] == 8


def test_victim_selection_rotates():
    f = WorkStealingFrontend(lambda: FakeBatcher(), n_replicas=3)
    f.submit(1, _req(10))
    f.submit(1, _req(11))
    f.submit(2, _req(20, 2))
    got = [f._next_request(0).rid for _ in range(3)]
    assert got.index(20) < 2, got
    assert sorted(got) == [10, 11, 20]
    assert f._next_request(0) is None


def test_wswmult_owner_fifo_and_weak_multiplicity():
    """Take/Steal drain FIFO; a stale Head write lets a thief re-extract a
    task, but no process ever extracts the same task twice."""
    q = WSWMult(storage="linked", node_len=4)
    for i in range(10):
        q.put(i)
    assert [q.take() for _ in range(3)] == [0, 1, 2]
    assert [q.steal(1) for _ in range(2)] == [3, 4]
    q.Head.write(1, 0)                    # stale republish rewinds Head
    assert q.steal(2) == 0                # a fresh thief re-extracts
    again = [q.steal(1) for _ in range(6)]
    assert again[:5] == [5, 6, 7, 8, 9] and again[5] is EMPTY  # thief 1: no repeats
    assert q.take() is EMPTY


def test_moe_frontend_streams_match_jax_engine():
    """kimi-k2 SMOKE with moe_dispatch="ws": the 2-replica frontend's greedy
    streams equal the JAX engine's, and each batcher takes the ws step."""
    jax = pytest.importorskip("jax")
    from repro.configs.kimi_k2_1t_a32b import SMOKE as J_KIMI
    from repro.models import init_params as j_init
    from repro.serving.engine import ContinuousBatcher as JBatcher
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import WorkStealingFrontend as JFrontend
    from repro_torch.configs.kimi_k2_1t_a32b import SMOKE as KIMI
    from repro_torch.convert import params_from_jax
    from repro_torch.serving import ContinuousBatcher

    jcfg, tcfg = J_KIMI.replace(moe_dispatch="ws"), KIMI.replace(moe_dispatch="ws")
    jp = j_init(jax.random.PRNGKey(4), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, (6,)).astype(np.int32) for _ in range(4)]

    def serve(front, req_cls):
        for rid, p in enumerate(prompts):
            front.submit(0, req_cls(rid=rid, tokens=p, max_new=2))
        done = front.run(max_iters=100)
        return {rid: list(r.out) for rid, r in done.items()}, front

    want, _ = serve(JFrontend(lambda: JBatcher(jp, jcfg, slots=2, capacity=16),
                              n_replicas=2), JRequest)
    got, front = serve(WorkStealingFrontend(
        lambda: ContinuousBatcher(tp, tcfg, slots=2, capacity=16), n_replicas=2), Request)
    assert got == want and sorted(got) == [0, 1, 2, 3]
    assert all(b.use_ws for b in front.batchers)


def test_moe_batcher_takes_the_ws_step(monkeypatch):
    """A MoE config's batcher decodes with decode_step_ws, never the dense
    decode_step, and its MoE layers go through the ws dispatch."""
    from repro_torch.configs.kimi_k2_1t_a32b import SMOKE as KIMI
    from repro_torch.models import init_params
    from repro_torch.moe_ws import layer
    from repro_torch.serving import ContinuousBatcher, engine

    cfg = KIMI.replace(moe_dispatch="ws")
    calls = {"ws": 0, "moe_ws": 0}

    def ws_step(*a, **kw):
        calls["ws"] += 1
        return decode_ws(*a, **kw)

    def moe_ws(*a, **kw):
        calls["moe_ws"] += 1
        return moe(*a, **kw)

    def dense_step(*a, **kw):
        raise AssertionError("the dense decode step ran")

    decode_ws, moe = engine.decode_step_ws, layer.moe_ffn_ws
    monkeypatch.setattr(engine, "decode_step_ws", ws_step)
    monkeypatch.setattr(engine, "decode_step", dense_step)
    monkeypatch.setattr(layer, "moe_ffn_ws", moe_ws)
    monkeypatch.setattr("repro_torch.moe_ws.moe_ffn_ws", moe_ws)
    b = ContinuousBatcher(init_params(cfg, seed=0, device="cpu"), cfg, slots=2, capacity=16)
    assert b.use_ws
    assert b.admit(Request(0, np.arange(5, dtype=np.int32), max_new=3))
    b.step()
    assert calls["ws"] == 1
    assert calls["moe_ws"] == 2 * cfg.n_layers  # one prefill and one decode step
