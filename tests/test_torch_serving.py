"""The port's continuous-batching engine and scheduler: any K, any
interleaving and any preemption pattern give each request the tokens of
a solo run, and the same tokens as the JAX package's ServingEngine on
the same prompts."""

import numpy as np
import pytest
import torch

from repro import compiler as jax_compiler
from repro.serving import Request as JaxRequest
from repro_torch import compiler
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm
from repro_torch.serving import Request, SchedulerConfig
from test_torch_generate import op_by_op, pair

# smoke shapes gain nothing from intra-op threads, which only contend
# with the other test workers
torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"
MAX_LEN = 40


def _model(seed=0):
    cfg = get_smoke_config(ARCH)
    return cfg, lm.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in lengths]


def _solo(cm, prompt, n_new):
    """One request alone: prefill, then batch-1 decode steps, in a cache
    of the serving pool's capacity."""
    logits, pre = cm.prefill(torch.as_tensor(prompt, dtype=torch.int64)[None])
    caches = cm.graft_prefill_caches(cm.init_cache(1, MAX_LEN), pre)
    out = [int(torch.argmax(logits[0]))]
    for i in range(n_new - 1):
        logits, caches = cm.decode_step(torch.tensor([out[-1]]), len(prompt) + i, caches)
        out.append(int(torch.argmax(logits[0])))
    return out


@pytest.mark.parametrize("k", [1, 2, 3])
def test_requests_equal_solo_across_k(k):
    cfg, params = _model()
    cm = compiler.compile(cfg, params, compiler.HardwareTarget(engine="packed", group_size=k),
                          device="cpu")
    prompts = _prompts(cfg, (5, 9, 7, 12, 3))
    n_new = 6
    refs = [_solo(cm, p, n_new) for p in prompts]
    se = cm.serve(max_batch=3, max_len=MAX_LEN)
    assert se.group_k == k
    states = [se.submit(Request(rid=i, prompt=p, max_new_tokens=n_new))
              for i, p in enumerate(prompts[:3])]
    se.step()
    states += [se.submit(Request(rid=i + 3, prompt=p, max_new_tokens=n_new))
               for i, p in enumerate(prompts[3:])]  # arrive mid-flight
    se.drain()
    assert all(s.done for s in states)
    for st, ref in zip(states, refs):
        assert st.generated == ref, f"request {st.rid}"
    stats = se.stats()
    assert stats.prefills == 5 and stats.decoded == 5 * (n_new - 1)
    assert stats.mmm_groups >= stats.ticks


@pytest.mark.parametrize(
    "sched",
    [
        # a strictly higher-priority arrival evicts a running request
        SchedulerConfig(),
        # partial admission over-commits the reserve-shrunk KV budget
        SchedulerConfig(admission="partial", kv_reserve_ratio=0.5),
    ],
    ids=["priority", "partial-budget"],
)
def test_preemption_and_restore_equal_solo(sched):
    cfg, params = _model(1)
    cm = compiler.compile(cfg, params, compiler.HardwareTarget(engine="packed"), device="cpu")
    prompts = _prompts(cfg, (6, 8, 5), seed=1)
    n_new = 10
    refs = [_solo(cm, p, n_new) for p in prompts]
    se = cm.serve(max_batch=2, max_len=MAX_LEN, scheduler=sched)
    states = [se.submit(Request(rid=i, prompt=p, max_new_tokens=n_new))
              for i, p in enumerate(prompts[:2])]
    for _ in range(3):
        se.step()
    states.append(se.submit(Request(rid=2, prompt=prompts[2], max_new_tokens=n_new,
                                    priority=5)))
    se.drain()
    stats = se.stats()
    assert stats.scheduler.preempted >= 1 and stats.scheduler.resumed >= 1
    assert stats.evictions == stats.restores >= 1
    for st, ref in zip(states, refs):
        assert st.done and st.generated == ref, f"request {st.rid}"


def test_streaming_and_rejection():
    cfg, params = _model()
    cm = compiler.compile(cfg, params, compiler.HardwareTarget(engine="packed"), device="cpu")
    prompt = _prompts(cfg, (7,))[0]
    se = cm.serve(max_batch=2, max_len=MAX_LEN)
    assert list(se.stream(Request(rid=0, prompt=prompt, max_new_tokens=5))) == _solo(cm, prompt, 5)
    too_long = se.submit(Request(rid=1, prompt=np.zeros(MAX_LEN, np.int32), max_new_tokens=2))
    assert too_long.status.value == "rejected"


def test_serving_matches_jax_serving_engine():
    """The same prompts through both packages' ServingEngines (packed,
    2 slots, staggered arrivals); the reference runs op by op."""
    jcfg, jparams, cfg, model = pair(ARCH, seed=2)
    prompts = _prompts(cfg, (6, 9, 4), seed=2)
    n_new = 5

    def drive(se, request_cls):
        states = [se.submit(request_cls(rid=0, prompt=prompts[0], max_new_tokens=n_new)),
                  se.submit(request_cls(rid=1, prompt=prompts[1], max_new_tokens=n_new))]
        se.step()
        states.append(se.submit(request_cls(rid=2, prompt=prompts[2], max_new_tokens=n_new)))
        se.drain()
        return [s.generated for s in states]

    with op_by_op():
        jse = jax_compiler.compile(
            jcfg, jparams, jax_compiler.HardwareTarget(engine="packed")
        ).serve(max_batch=2, max_len=MAX_LEN)
        want = drive(jse, JaxRequest)
    cm = compiler.compile(cfg, model, compiler.HardwareTarget(engine="packed"), device="cpu")
    got = drive(cm.serve(max_batch=2, max_len=MAX_LEN), Request)
    assert got == want
