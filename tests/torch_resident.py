"""Resident bf16 weights (``lm.program_weights``) against the per-call
cast, shared by tests/test_torch_{moe,ssm,granite}.py: a smoke model
compiled onto ``packed``, whose MoE and Mamba modules hold bf16 copies of
their expert stacks and projections, beside the same compiled model with
those modules swapped for the input model's, which hold none, so each
product casts its fp32 weights per call."""

import torch
from test_torch_decode_graph import FakeGraphs

from repro_torch import compiler, obs
from repro_torch import tree as tree_lib
from repro_torch.compiler import decode_graph
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm, moe, ssm
from repro_torch.models.layers import CAST_COUNTER, RESIDENT

BATCH, PROMPT, SUFFIX, STEPS, MAX_LEN = 3, 6, 3, 5, 16


def compiled(arch: str, seed: int = 0):
    """(cfg, the input model, it compiled onto ``packed``)."""
    cfg = get_smoke_config(arch)
    model = lm.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    return cfg, model, compiler.compile(cfg, model, compiler.HardwareTarget(engine="packed"),
                                        device="cpu")


def casting(cm, model) -> None:
    """``cm`` made to cast per call: its MoE and Mamba modules replaced by
    ``model``'s, everything else (the programmed projections) kept."""
    p = cm.params
    blocks = [lm.Block(pb.norm1, ob.mixer if isinstance(ob.mixer, ssm.Mamba) else pb.mixer,
                       pb.norm2, ob.ffn if isinstance(ob.ffn, moe.MoE) else pb.ffn)
              for pb, ob in zip(p.blocks, model.blocks)]
    cm.params = lm.LM(p.embed, p.final_norm, p.head, blocks, p.n_slots)
    assert lm.resident_bytes(cm.params) == 0


def residents(model) -> dict:
    return {n: t for n, t in model.named_buffers() if n.endswith(RESIDENT)}


def _flat(caches: dict) -> list[torch.Tensor]:
    return [t for slot in sorted(caches) for _, t in sorted(caches[slot].items())]


def outputs(cm, graphed: bool, seed: int = 1) -> list[torch.Tensor]:
    """A prefill's logits and caches, a continuation's over the prompt's
    last ``SUFFIX`` tokens where the stack is attention only, and
    ``STEPS`` greedy decode steps' logits and caches: eager, or captured
    and replayed (``FakeGraphs``, which reruns the captured step)."""
    if graphed:
        backend = FakeGraphs()
        cm.decode_graphs = decode_graph.DecodeGraphs(backend)
        backend.cache = getattr(cm.executor(BATCH), "weight_cache", None)
    tokens = torch.randint(0, cm.cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(seed))
    logits, pre = cm.prefill(tokens)
    out = [logits, *_flat(pre)]
    if all(kind.mixer == "attn" for kind in cm.cfg.pattern):
        _, head_caches = cm.prefill(tokens[:, :-SUFFIX])
        cont, cont_caches = cm.prefill_continue(tokens[:, -SUFFIX:], head_caches)
        out += [cont, *_flat(cont_caches)]
    caches = cm.graft_prefill_caches(cm.init_cache(BATCH, MAX_LEN), pre)
    tok = torch.argmax(logits, dim=-1)
    with torch.no_grad():
        for i in range(STEPS):
            logits, caches = cm.decode_step(tok, PROMPT + i, caches)
            out.append(logits.clone())
            tok = torch.argmax(logits, dim=-1)
    if graphed:
        assert backend.replays == STEPS - 2
    return out + _flat(caches)


def assert_resident_equals_cast(arch: str, graphed: bool) -> None:
    """The programmed model's outputs equal the per-call cast's bit for
    bit, and only the programmed one reads resident copies."""
    _, model, cm = compiled(arch)
    assert lm.resident_bytes(cm.params) > 0
    with obs.session() as tel:
        got = outputs(cm, graphed)
    assert _outcomes(tel) == {"resident"}
    casting(cm, model)
    with obs.session() as tel:
        want = outputs(cm, graphed)
    assert _outcomes(tel) == {"cast"}
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and torch.equal(a, b), i


def _outcomes(tel) -> set:
    return {dict(key)["outcome"] for key in tel.metrics.counter(CAST_COUNTER)._series}


def assert_programming_leaves_the_input_as_it_was(arch: str) -> None:
    """``program_weights`` builds new MoE and Mamba modules over the same
    fp32 leaves: the input model's modules are the ones they were, with
    the values they had and no copies; the programmed ones' ``leaves()``
    are the same storage with the same values, and their copies equal the
    per-call cast."""
    cfg = get_smoke_config(arch)
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    before = {n: t.clone() for n, t in model.named_parameters()}
    names = {id(t): n for n, t in model.named_parameters()}
    modules = [(blk.mixer, blk.ffn) for blk in model.blocks]
    cm = compiler.compile(cfg, model, compiler.HardwareTarget(engine="packed"), device="cpu")
    assert [(blk.mixer, blk.ffn) for blk in model.blocks] == modules
    assert residents(model) == {}
    for n, t in model.named_parameters():
        assert torch.equal(t, before[n]), n
    copies = 0
    for blk, src in zip(cm.params.blocks, model.blocks):
        for new, old in ((blk.mixer, src.mixer), (blk.ffn, src.ffn)):
            if not isinstance(old, (moe.MoE, ssm.Mamba)):
                continue
            assert new is not old and type(new) is type(old)
            got = tree_lib.leaves_with_paths(new.leaves())
            want = tree_lib.leaves_with_paths(old.leaves())
            assert [path for path, _ in got] == [path for path, _ in want]
            for (path, a), (_, b) in zip(got, want):
                assert a.dtype == torch.float32 and a.data_ptr() == b.data_ptr(), path
                assert torch.equal(a, before[names[id(b)]]), path
            for name, copy in residents(new).items():
                w = getattr(new, name[: -len(RESIDENT)])
                assert copy.dtype == torch.bfloat16 and torch.equal(copy, w.to(torch.bfloat16))
                copies += 1
    assert copies > 0
