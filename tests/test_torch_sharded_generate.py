"""Greedy generation over the mesh's tensor and fsdp axes on the CPU (gloo
ranks, `tests/torch_dist_support.py`), `tests/test_sharded_inference.py`'s
case: the tiny config at vocab 1000, B 2, L 10, 6 new tokens, f32.

Each rank builds the model on the meta device, cuts it to its blocks
(`parallel.fsdp.shard_model`: the LM's named leaves over tensor, every
frozen leaf in a gathered block over fsdp) and loads them from the whole
state dict one leaf at a time. Over (fsdp 2, tensor 2), (tensor 2) and
(tensor 4) (the last with the 2 KV heads replicated: each rank computes
the one its query head reads):

* the tokens equal the JAX package's unsharded `greedy_generate` (JAX's
  slow `test_sharded_inference.py` ties its sharded run to that one), and
  each step's logits are within 1e-5 of max|logit| of the port's unsharded
  run, on every rank;
* in int8 and int4 the same against the port's unsharded quantized run
  (int4 on an 8-head variant of the tiny config: the tiny o_proj's 32
  packed rows over 2 ranks would split a scale group, which the port
  refuses with ValueError, also checked); with an int8 KV cache the tokens
  and the prefill's logits the same, the decode steps' logits within
  KV_INT8_TOL (each KV vector is rounded to 8 bits of its absmax, so a
  1e-7 difference in a key can move one element by absmax / 127);
* suppressed ids banned in the rank that holds them, and speculative greedy
  (the model as its own draft) equal to greedy, at tensor 2;
* the row-parallel int4 and W8A8 products (`QuantLinear.row_parallel` and
  the sum over the group) equal `dequantize_int4` / `int8_w8a8_matmul` on
  the whole K;
* a rank holds half the LM's entries at tensor 2 and a quarter of every
  gathered block's frozen entries at (fsdp 2, tensor 2);
* the float ranks fill their blocks from the flax tree one leaf at a time
  (`convert.load_flax_tree`), and `flax_tree_from_torch` gathers the same
  tree back from the sharded model.
"""
import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rga3_tpu.models.qwen25vl import generate as jgen
from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
from rga3_tpu.models.qwen25vl.model import Qwen25VL as JaxQwen
from rga3_tpu_torch.convert import flax_tree_from_torch, torch_state_dict_from_flax
from rga3_tpu_torch.models.qwen25vl import generate as tgen
from rga3_tpu_torch.models.qwen25vl import tiny_config
from rga3_tpu_torch.models.qwen25vl.model import Qwen25VL
from rga3_tpu_torch.ops import quant as tq

import torch_dist_support as tds
from torch_port_support import jax_param_tree

B, L, NEW, EOS, PAD = 2, 10, 6, 999, 0
LOGIT_TOL = 1e-5
KV_INT8_TOL = 4e-3
MESHES = {"fsdp2-tensor2": dict(fsdp=2, tensor=2), "tensor2": dict(tensor=2),
          "tensor4": dict(tensor=4)}
ROWS = 40  # tokens of the row-parallel products: W8A8 from 32


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 900, (B, L))
    return dict(input_ids=ids, attention_mask=np.ones((B, L), np.int64),
                position_ids=np.broadcast_to(np.arange(L)[None, None], (3, B, L)).copy(),
                rope_deltas=np.zeros(B, np.int64),
                gen=dict(max_new_tokens=NEW, eos_token_id=EOS, pad_token_id=PAD))


def _port(cfg, sd, flags=None, bits=None):
    """The port's whole model on `sd`, with the LM's `flags`, quantized (LM
    only) when asked."""
    model = Qwen25VL(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    tq.set_config_flags(model, flags or {}, {})
    if bits:
        tq.quantize_qwen_params(model, bits=bits)
    return model.eval()


def _run(model, kw, **extra):
    t = {k: torch.as_tensor(v) for k, v in kw.items() if k != "gen"}
    return tgen.greedy_generate(model, **t, **kw["gen"], return_logits=True, **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_generate")
    kw = _inputs()
    jcfg = jax_tiny_config(vocab_size=1000)
    jm = JaxQwen(jcfg)
    params = jax_param_tree(jm, input_ids=jnp.zeros((1, 8), jnp.int32), seed=5, std=0.1)
    jax_tokens = np.asarray(jgen.greedy_generate(
        jm, params, input_ids=jnp.asarray(kw["input_ids"], jnp.int32),
        attention_mask=jnp.asarray(kw["attention_mask"], jnp.int32),
        position_ids=jnp.asarray(kw["position_ids"], jnp.int32),
        rope_deltas=jnp.zeros((B,), jnp.int32), compute_dtype=jnp.float32, **kw["gen"]))
    cfg = tiny_config(1000)
    # the JAX tree of a text-only init has no vision tower: the port's seeded
    # draws stand in for it (no test prompt reaches it)
    base = Qwen25VL(cfg, device="cpu")
    base.init_weights(torch.Generator().manual_seed(5), std=0.1)
    sd = {**base.state_dict(), **torch_state_dict_from_flax(params)}
    # 8 query heads: o_proj's 128 input rows pack into 64, 32 a rank at tensor 2
    cfg8 = cfg.replace(text=cfg.text.replace(num_attention_heads=8))
    m8 = Qwen25VL(cfg8, device="cpu")
    m8.init_weights(torch.Generator().manual_seed(7), std=0.1)
    sd8 = m8.state_dict()
    modes = {
        "float": (cfg, sd, None, None),
        "int8": (cfg, sd, {"quant_int8": True, "quant_w8a8": True}, 8),
        "kv_int8": (cfg, sd, {"kv_cache_int8": True}, None),
        "int4": (cfg8, sd8, {"quant_int4": True}, 4),
        "int4-tiny": (cfg, sd, {"quant_int4": True}, 4),
    }
    reference, jobs = {}, []
    rng = np.random.default_rng(3)
    for mode, (c, s, flags, bits) in modes.items():
        whole = _port(c, s, flags, bits)
        path = tmp / f"{mode}.pt"
        torch.save(whole.state_dict(), path)
        if mode == "float":  # the float ranks load the flax tree, leaf by leaf
            with open(tmp / "tree.pkl", "wb") as f:
                pickle.dump(flax_tree_from_torch(whole), f)
        reference[mode] = _run(whole, kw) if mode != "int4-tiny" else None
        mcfg = whole.cfg  # the quantized flags the port set
        for name, mesh in MESHES.items():
            if mode.startswith("int") and name == "tensor4":
                continue
            if mode == "int4-tiny" and name != "tensor2":
                continue
            job = {"name": f"{mode}/{name}", "mesh": mesh, "cfg": mcfg, "sd": str(path),
                   "kw": kw}
            if mode == "float":
                job["tree"] = str(tmp / "tree.pkl")
            if mode == "float" and name == "tensor2":
                job["spec"] = True
            if mode in ("int8", "int4") and name == "tensor2":
                lin = whole.lm.model.layers_0.mlp.down_proj
                x = rng.standard_normal((1, ROWS, lin.in_features)).astype(np.float32)
                job["rows"] = x
                with torch.no_grad():
                    xt = torch.from_numpy(x)
                    if bits == 4:
                        want = xt @ tq.dequantize_int4(lin.kernel_q4, lin.scale_g)
                    else:
                        want = tq.int8_w8a8_matmul(xt, lin.kernel_q, lin.scale)
                reference[f"{mode}/rows"] = (want.numpy(), lin(xt).numpy())
            jobs.append(job)
    sup = [int(t) for t in reference["float"][0][:, 0]]
    reference["suppress"] = _run(_port(cfg, sd), kw, suppress_ids=sup)
    reference["suppress_ids"] = sup
    jobs.append({"name": "suppress/tensor2", "mesh": MESHES["tensor2"], "cfg": cfg,
                 "sd": str(tmp / "float.pt"), "kw": kw, "suppress": sup})
    with open(tmp / "jobs.pkl", "wb") as f:
        pickle.dump(jobs, f)
    two = tds.Ranks(tds.generate_ranks, 2, str(tmp / "jobs.pkl"))
    four = tds.Ranks(tds.generate_ranks, 4, str(tmp / "jobs.pkl"))
    ranks = two.results() + four.results()
    got = {}
    for rank in ranks:
        for name, rec in rank.items():
            got.setdefault(name, []).append(rec)
    whole = torch.load(tmp / "float.pt")
    named = ("proj.weight", "embed_tokens.weight", "lm_head.weight")

    def count(keep):
        return sum(t.numel() for k, t in whole.items() if keep(k))

    sizes = {"visual": count(lambda k: k.startswith("visual.")),
             "named": count(lambda k: k.startswith("lm.") and k.endswith(named)),
             "kv": count(lambda k: k.startswith("lm.") and k.endswith(("k_proj.weight",
                                                                      "v_proj.weight"))),
             "rest": count(lambda k: k.startswith("lm.") and not k.endswith(named))}
    return {"jax": jax_tokens, "reference": reference, "got": got, "sizes": sizes}


CASES = [(mode, mesh) for mode in ("float", "int8", "int4", "kv_int8") for mesh in sorted(MESHES)
         if mode == "float" or mesh != "tensor4"]


@pytest.mark.parametrize("mode,mesh", CASES, ids=[f"{a}-{b}" for a, b in CASES])
def test_sharded_greedy_matches_unsharded(runs, mode, mesh):
    tokens, logits = runs["reference"][mode]
    if mode == "float":
        # the port's unsharded run is JAX's, token for token
        np.testing.assert_array_equal(tokens.numpy(), runs["jax"])
    records = runs["got"][f"{mode}/{mesh}"]
    assert len(records) == np.prod(list(MESHES[mesh].values()))
    scale = logits.abs().amax(-1, keepdim=True).numpy()
    for rec in records:
        assert rec["mesh"]["tensor"] == MESHES[mesh]["tensor"]
        np.testing.assert_array_equal(rec["tokens"], tokens.numpy())
        err = np.abs(rec["logits"] - logits.numpy()) / scale
        if mode == "kv_int8":  # the prefill reads no cache
            assert err[:, 0].max() <= LOGIT_TOL and err.max() <= KV_INT8_TOL, err.max()
        else:
            assert err.max() <= LOGIT_TOL, err.max()
    # the 2 KV heads: one a rank at tensor 2, replicated over 4 ranks
    assert {rec["kv_heads"] for rec in records} == {1}
    if mode == "float":  # loaded from the flax tree leaf by leaf, gathered back whole
        assert all(rec["tree_back"] for rec in records)


def test_sharded_entries_are_blocks(runs):
    """What a rank holds: the LM's named leaves (the projections, the
    embedding, the head) split over tensor, its biases and norms and the
    vision tower whole over tensor; at (fsdp 2, tensor 2) every frozen entry
    of a gathered block halved again (the tiny model's all are)."""
    n = runs["sizes"]
    held = {name: runs["got"][f"float/{name}"][0]["held"] for name in MESHES}
    assert held["tensor2"] == n["named"] // 2 + n["rest"] + n["visual"]
    assert held["fsdp2-tensor2"] == held["tensor2"] // 2
    # tensor 4: k / v keep a whole KV head of the 2
    assert held["tensor4"] == ((n["named"] - n["kv"]) // 4 + n["kv"] // 2 + n["rest"]
                               + n["visual"])


def test_suppress_and_speculative_over_tensor2(runs):
    tokens, logits = runs["reference"]["suppress"]
    for rec in runs["got"]["suppress/tensor2"]:
        np.testing.assert_array_equal(rec["tokens"], tokens.numpy())
        assert np.isneginf(rec["logits"][:, 0][np.arange(B), runs["reference"]["suppress_ids"]
                                               ]).all()
    for rec in runs["got"]["float/tensor2"]:
        np.testing.assert_array_equal(rec["spec"], rec["greedy_row0"])
        np.testing.assert_array_equal(rec["spec"], runs["reference"]["float"][0][:1].numpy())


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_row_parallel_quantized_products(runs, mode):
    """int4's packed-halves row block and W8A8's token scale over the whole
    K: the ranks' summed products equal the whole layer's."""
    want, whole = runs["reference"][f"{mode}/rows"]
    np.testing.assert_allclose(whole, want, rtol=0, atol=1e-5 * np.abs(want).max())
    for rec in runs["got"][f"{mode}/tensor2"]:
        np.testing.assert_allclose(rec["rows"], want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_int4_row_block_that_splits_a_group_is_refused(runs):
    for rec in runs["got"]["int4-tiny/tensor2"]:
        assert "multiple of 32" in rec["error"], rec
