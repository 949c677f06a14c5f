"""granite-4.0-h-small in the port, held to the benchmark's plain
reference (``bench/reference/hybrid.py``: plain torch in fp32, the
Mamba-2 mixer as its sequential recurrence, nothing of the port) at the
smoke size on seeded weights; the JAX package has no Granite to compare
with. Weights come from the benchmark's layout for this model
(``bench/models/granite.py``) and its configuration's draw, and reach the
port through its own constructors.

Tolerances, each with its reason (all relative: ``||port - ref|| /
||ref - input||`` for a sublayer, ``||port - ref|| / ||ref||`` for
logits):

* a Mamba-2 or MoE sublayer fed the reference's own input: 0.02. bf16
  storage rounds every stored value (2^-9 relative), and the port's
  chunked SSD and row-blocked products sum in another order than the
  reference's recurrence; 0.005-0.007 measured.
* the attention sublayer: 0.1. Its q/k/v/o are BitLinears, so a sign that
  bf16 rounding flips in a near-zero activation moves a whole +-alpha term;
  0.003-0.04 measured. Its q and k weights are scaled up 30x here, so the
  softmax is sharp and positions and the scale decide the output (at the
  seeded scale the NoPE attention is nearly uniform over the context).
* logits of the whole stack, by one forward or by prefill and cached
  decode: 0.35. Twenty sublayers carry each one's rounding on, and the
  binarized attention amplifies it; 0.10-0.26 measured over twelve seeds.

A planted omission in the port alone (RoPE where the model has none, the
default scale, a multiplier left at 1, no shared expert) reads over
these: 0.49-1.07 at the attention sublayer; 0.58-0.66 for the logits
without the residual multiplier, 1.2 or more without the embedding
multiplier or the shared expert, 15 without the logit divisor.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_resident

from repro_torch import compiler
from repro_torch.configs import ARCH_IDS, SERVED, get_config, get_smoke_config
from repro_torch.distributed import ep
from repro_torch.kernels import rows
from repro_torch.kernels.rows import per_sequence, seq_matmul, sequence_products
from repro_torch.models import lm, moe
from repro_torch.models.layers import rms_norm
from repro_torch.serving import Request

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.models import granite  # noqa: E402
from bench.weights import make_weights  # noqa: E402

torch.set_num_threads(1)

ARCH = "granite-4.0-h-small"
WEIGHTS = json.loads((ROOT / "bench/configs/granite-4.0-h-small.1of4.json").read_text())["weights"]
T = 48
ATTN = 5  # the attention layer of the period
SUBLAYER_TOL, ATTN_TOL, LOGITS_TOL = 0.02, 0.1, 0.35
FAULTS = {
    "rope": {"rope": True},
    "scale": {"attn_scale": 0.0},
    "embedding_multiplier": {"embedding_multiplier": 1.0},
    "residual_multiplier": {"residual_multiplier": 1.0},
    "logits_scaling": {"logits_scaling": 1.0},
    "shared_expert": {},
}


def _setup(seed: int, qk: float = 1.0):
    """(cfg, sizes, weights, the port's model, the reference) at the
    smoke size; ``qk`` scales the attention layer's q and k weights."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), quant="bnn")
    sz = granite.sizes(cfg)
    w = make_weights(granite.layout(sz, WEIGHTS), seed, "cpu")
    for name in ("q", "k"):
        w[f"layers.{ATTN}.{name}"].mul_(qk)
    return cfg, sz, w, granite.build(w, sz), granite.Reference(w, sz, torch.bfloat16)


def _ids(cfg, seed: int, n: int = T) -> torch.Tensor:
    return torch.randint(0, cfg.vocab_size, (n,), generator=torch.Generator().manual_seed(seed))


def _rel(got: torch.Tensor, want: torch.Tensor, base=0.0) -> float:
    return float((got - want).norm() / (want - base).norm())


@torch.no_grad()
def _forward_logits(model, ids, cfg) -> torch.Tensor:
    """Every position's logits by the port's training forward (the
    chunked SSD, no cache) and its head."""
    h, _ = lm.backbone(model, lm.embed_tokens(model, ids[None], cfg),
                       torch.arange(ids.shape[0]), cfg)
    logits = lm._logit_scaled(h[0].to(torch.float32) @ lm._head_weights(model, cfg), cfg)
    return logits[:, : cfg.vocab_size]


@torch.no_grad()
def _sublayers(model, ref, cfg, x):
    """Each sublayer of the port fed the reference's input to it:
    (kind, port output, reference output, input) layer by layer."""
    out = []
    for i, blk in enumerate(model.blocks):
        want = ref.mixer_sublayer(x, i)
        hb = x[None].to(torch.bfloat16)
        mix, _ = lm._mix(blk, rms_norm(hb, blk.norm1, cfg.norm_eps), torch.arange(x.shape[0]),
                         cfg, None)
        out.append((cfg.pattern[i].mixer, lm._residual(hb, mix, cfg)[0].float(), want, x))
        got, _ = lm._ffn_residual(blk, want[None].to(torch.bfloat16), cfg, None)
        x = ref.ffn_sublayer(want, i, [(0, x.shape[0])])
        out.append(("ffn", got[0].float(), x, want))
    return out


def _fault(cfg, name, monkeypatch):
    """The port's config with ``name`` planted (the reference unchanged)."""
    if name == "shared_expert":
        monkeypatch.setattr(moe, "shared_expert", lambda p, x: torch.zeros_like(x))
    return dataclasses.replace(cfg, **FAULTS[name])


def test_registered_and_counted():
    cfg = get_config(ARCH)
    assert ARCH in ARCH_IDS and ARCH in SERVED and cfg.family == "hybrid"
    assert [k.mixer for k in cfg.pattern] == ["mamba"] * 5 + ["attn"] + ["mamba"] * 4
    # the published 32B-A9B: 72 experts, top-10, and the shared expert on every token
    assert cfg.param_count() == 32_206_738_944
    assert cfg.active_param_count() == 8_802_522_624
    no_shared = dataclasses.replace(cfg, moe_shared_ff=0)
    assert cfg.param_count() - no_shared.param_count() == 40 * 3 * 4096 * 1536
    assert cfg.active_param_count() - no_shared.active_param_count() == 40 * 3 * 4096 * 1536


def test_layout_counts_every_parameter_at_one_stage():
    """The benchmark's stage of 10 layers: 8,360,118,912 parameters in
    its layout. ``param_count`` keeps the JAX reference's analytic Mamba
    count, which leaves out the conv biases and the gated norm's scale
    (d_inner + 2 G N + d_inner a layer; the dry-run's FLOPs are held to
    the reference's)."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=10)
    sz = granite.sizes(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in granite.layout(sz, WEIGHTS))
    assert total == 8_360_118_912
    unmodelled = 9 * (2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state)
    assert cfg.param_count() + unmodelled == total
    smoke = granite.sizes(get_smoke_config(ARCH))
    assert sum(math.prod(s) for _, s, _, _ in granite.layout(smoke, WEIGHTS)) == (
        get_smoke_config(ARCH).param_count() + 9 * (2 * 128 + 2 * 16))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_full_forward_logits_match_the_reference(seed):
    cfg, sz, w, model, ref = _setup(seed)
    ids = _ids(cfg, seed)
    want = ref.logits(ids, None, [(0, T)], torch.arange(T))
    assert _rel(_forward_logits(model, ids, cfg), want) < LOGITS_TOL


@pytest.mark.parametrize("seed", [1, 2])
def test_each_sublayer_matches_the_reference(seed):
    cfg, sz, w, model, ref = _setup(seed, qk=30.0)
    x = ref.embed(_ids(cfg, seed), None)
    for kind, got, want, inp in _sublayers(model, ref, cfg, x):
        assert _rel(got, want, inp) < (ATTN_TOL if kind == "attn" else SUBLAYER_TOL), kind


@pytest.mark.parametrize("engine", ["packed", "reference"])
def test_prefill_then_cached_decode_matches_the_full_forward(engine):
    """A prompt's prefill, then decode steps through the caches (Mamba
    conv tails and state, the attention layer's K/V): each step's logits
    against the reference's one forward over the same tokens, which
    routes the prompt as one call and each decoded token alone."""
    cfg, sz, w, model, ref = _setup(4)
    cm = compiler.compile(cfg, model, compiler.HardwareTarget(engine=engine), device="cpu")
    ids, p = _ids(cfg, 4), 30
    with torch.no_grad():
        logits, pre = cm.prefill(ids[None, :p])
        caches = cm.graft_prefill_caches(cm.init_cache(1, T), pre)
        got = [logits[0]]
        for i in range(p, T - 1):
            logits, caches = cm.decode_step(ids[i : i + 1], i, caches)
            got.append(logits[0])
    calls = [(0, p)] + [(i, i + 1) for i in range(p, T - 1)]
    want = ref.logits(ids[: T - 1], None, calls, torch.arange(p - 1, T - 1))
    assert _rel(torch.stack(got)[:, : cfg.vocab_size], want) < LOGITS_TOL


def _solo(cm, prompt, n_new, max_len):
    logits, pre = cm.prefill(torch.as_tensor(prompt, dtype=torch.int64)[None])
    caches = cm.graft_prefill_caches(cm.init_cache(1, max_len), pre)
    out = [int(torch.argmax(logits[0]))]
    for i in range(n_new - 1):
        logits, caches = cm.decode_step(torch.tensor([out[-1]]), len(prompt) + i, caches)
        out.append(int(torch.argmax(logits[0])))
    return out


@torch.no_grad()
def test_serving_batched_equals_each_request_alone():
    """The hybrid slot pool (nine Mamba slots of conv tails and state,
    one of K/V): four requests through 3 slots, one arriving mid-flight,
    generate what each does alone."""
    cfg, sz, w, model, ref = _setup(5)
    cm = compiler.compile(cfg, model, compiler.HardwareTarget(engine="packed"), device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 11, 2, 8)]
    refs = [_solo(cm, p, 6, 32) for p in prompts]
    se = cm.serve(max_batch=3, max_len=32)
    assert not se.supports_prefix_graft
    states = [se.submit(Request(rid=i, prompt=p, max_new_tokens=6))
              for i, p in enumerate(prompts[:3])]
    se.step()
    states.append(se.submit(Request(rid=3, prompt=prompts[3], max_new_tokens=6)))
    se.drain()
    assert [s.generated for s in states] == refs


@pytest.mark.parametrize("fault", ["rope", "scale"])
def test_an_attention_fault_in_the_port_is_caught(fault, monkeypatch):
    cfg, sz, w, model, ref = _setup(1, qk=30.0)
    bad = _fault(cfg, fault, monkeypatch)
    h = ref.embed(_ids(cfg, 1), None)
    for i in range(ATTN):
        h = ref.ffn_sublayer(ref.mixer_sublayer(h, i), i, [(0, T)])
    want = ref.mixer_sublayer(h, ATTN)
    blk = model.blocks[ATTN]
    hb = h[None].to(torch.bfloat16)
    with torch.no_grad():
        mix, _ = lm._mix(blk, rms_norm(hb, blk.norm1, cfg.norm_eps), torch.arange(T), bad, None)
        got = lm._residual(hb, mix, bad)[0].float()
    assert _rel(got, want, h) > 3 * ATTN_TOL


@pytest.mark.parametrize("fault", ["embedding_multiplier", "residual_multiplier",
                                   "logits_scaling", "shared_expert"])
def test_a_multiplier_or_the_shared_expert_left_out_is_caught(fault, monkeypatch):
    cfg, sz, w, model, ref = _setup(1)
    ids = _ids(cfg, 1)
    want = ref.logits(ids, None, [(0, T)], torch.arange(T))
    bad = _fault(cfg, fault, monkeypatch)
    assert _rel(_forward_logits(model, ids, bad), want) > LOGITS_TOL


def test_unit_multipliers_add_no_operation():
    """At their defaults the multipliers add no operation: the head's
    logits come back as they are, the residual add and the embedding
    lookup are the ones they were, so a configuration without them keeps
    its bits and its graph's launches."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    h, y = torch.randn(2, 3, 8).to(torch.bfloat16), torch.randn(2, 3, 8).to(torch.bfloat16)
    assert lm._logit_scaled(y, cfg) is y
    assert torch.equal(lm._residual(h, y, cfg), h + y)
    table, ids = torch.randn(16, 8), torch.tensor([[3, 5]])
    model = lm.LM(table, torch.ones(8), None, [], n_slots=1)
    assert torch.equal(lm.embed_tokens(model, ids, cfg), table[ids])


def test_the_expert_parallel_dispatch_refuses_a_shared_expert():
    cfg, sz, w, model, ref = _setup(1)
    with pytest.raises(ep.SharedExpertError, match="granite-smoke"):
        ep.ep_moe_ffn(model.blocks[0].ffn, torch.zeros(1, 2, cfg.d_model), cfg, mesh=None)


def test_only_granite_prefills_one_product_per_sequence():
    """The other configurations keep their row-blocked prefill, and so
    their bits: of the port's architectures only granite sets
    ``prefill_per_sequence``, and an attention-only stack, which a cached
    prefix can continue, refuses it."""
    assert [a for a in ARCH_IDS if get_config(a).prefill_per_sequence] == [ARCH]
    assert get_smoke_config(ARCH).prefill_per_sequence
    with pytest.raises(ValueError, match="never continued"):
        dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"), prefill_per_sequence=True)


def test_sequence_products_take_one_product_per_sequence_only_inside_the_context():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 40, 24, generator=g).to(torch.bfloat16)
    w = torch.randn(24, 8, generator=g).to(torch.bfloat16)
    assert not per_sequence(x)
    assert torch.equal(seq_matmul(x, w), rows.matmul(x, w))
    with sequence_products():
        assert per_sequence(x)
        got = seq_matmul(x, w)
        with sequence_products(False):
            assert not per_sequence(x)
        assert per_sequence(x)
    assert not per_sequence(x)
    assert torch.equal(got, torch.cat([torch.matmul(xs, w) for xs in x.split(1)]))


# the product sites that take one product per sequence in a flagged
# prefill (rows.by_sequence), and those that keep their row blocks
# everywhere (rows.blocks alone), by the function that owns the site
MODE_AWARE = ("route", "shared_expert", "experts", "_project", "multi_head_attention")
MODE_BLIND = ("_logits", "decode_attention", "ssd_step")


def _site(frame) -> str:
    """The innermost caller of a ``rows`` entry that owns a product site
    (``None``: no listed site)."""
    while frame is not None and frame.f_code.co_name not in MODE_AWARE + MODE_BLIND:
        frame = frame.f_back
    return frame and frame.f_code.co_name


@pytest.mark.parametrize("arch, sites", [
    pytest.param("mamba2-2.7b", None, id="mamba2-2.7b"),
    pytest.param("jamba-1.5-large-398b", None, id="jamba-1.5-large-398b"),
    pytest.param(ARCH, None, id=ARCH),
    pytest.param(ARCH, "mode-aware", id=f"{ARCH}-mode-aware-sites"),
    pytest.param(ARCH, "mode-blind", id=f"{ARCH}-mode-blind-sites"),
])
def test_only_the_flagged_prefill_runs_inside_the_context(arch, sites, monkeypatch):
    """A prefill takes one product per sequence exactly when its config
    asks, and a decode step never does. On granite, every mode-aware
    site takes its products one per sequence in the prefill and in row
    blocks in a decode step; the head, the decode lanes and the state
    readout take row blocks in both and never ask the mode."""
    cfg = get_smoke_config(arch)
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    seen, blocked = [], []
    by_sequence, blocks = rows.by_sequence, rows.blocks

    def spy(fn, split, shared=(), *, blocked):
        seen.append((_site(sys._getframe(1)), per_sequence(*split, *shared)))
        return by_sequence(fn, split, shared, blocked=blocked)

    def spy_blocks(fn, ts, shared=(), **kw):
        blocked.append(_site(sys._getframe(1)))
        return blocks(fn, ts, shared, **kw)

    monkeypatch.setattr(rows, "by_sequence", spy)
    monkeypatch.setattr(rows, "blocks", spy_blocks)
    ids = _ids(cfg, 1, 8)[None]
    with torch.no_grad():
        lm.prefill(model, ids, cfg)
        prefill = seen[:], blocked[:]
        seen.clear()
        blocked.clear()
        lm.decode_step(model, ids[:, 0], 0, lm.init_cache(cfg, 1, 16, device="cpu"), cfg)
    assert prefill[0] and set(on for _, on in prefill[0]) == {cfg.prefill_per_sequence}
    assert seen and not any(on for _, on in seen)
    if sites == "mode-aware":
        assert {site for site, _ in prefill[0]} == set(MODE_AWARE)
        assert not set(MODE_AWARE) & set(prefill[1])
        assert {site for site, _ in seen} == set(MODE_AWARE) - {"multi_head_attention"}
    elif sites == "mode-blind":
        assert set(prefill[1]) == {"_logits"}
        assert set(blocked) == set(MODE_BLIND) | set(MODE_AWARE) - {"multi_head_attention"}
        assert not set(MODE_BLIND) & {site for site, _ in prefill[0] + seen}


# ---------------------------------------------------------------------------
# Resident bf16 weights (lm.program_weights) == the per-call cast
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graph"])
def test_resident_weights_give_the_per_call_casts_bits(graphed):
    """granite's prefill (one product per sequence) and decode_step,
    eager or replayed, on the programmed model (routed and shared expert
    stacks, Mamba projections) == on the same model casting per call,
    bit for bit."""
    torch_resident.assert_resident_equals_cast(ARCH, graphed)


def test_programming_leaves_the_input_model_and_the_fp32_leaves_as_they_were():
    torch_resident.assert_programming_leaves_the_input_as_it_was(ARCH)


def test_an_optimizer_step_after_compile_moves_neither_outputs_nor_copies():
    """A model in training is compiled from a copy: an optimizer step on
    it afterwards leaves the compiled model's outputs and its resident
    copies as they were."""
    cfg = get_smoke_config(ARCH)
    model = lm.init_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    model.requires_grad_(True)
    cm = compiler.compile(cfg, model, compiler.HardwareTarget(engine="packed"), device="cpu")
    copies = {n: t.clone() for n, t in torch_resident.residents(cm.params).items()}
    assert copies
    want = torch_resident.outputs(cm, graphed=False)
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    logits, _ = lm.prefill(model, _ids(cfg, 2, 8)[None], cfg)
    logits.square().mean().backward()
    before = {n: t.detach().clone() for n, t in model.named_parameters()}
    opt.step()
    moved = [n for n, t in model.named_parameters() if not torch.equal(t, before[n])]
    assert any(".ffn.w1" in n for n in moved) and any("mixer.x_proj" in n for n in moved)
    assert all(torch.equal(t, copies[n])
               for n, t in torch_resident.residents(cm.params).items())
    got = torch_resident.outputs(cm, graphed=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
