"""Probe of the train step's compute dtypes under f32 parameters (the JAX
script's `--param_dtype float32`, the release default), on the CPU:

    python tests/probe_f32_modules.py dtypes
        the dtype of every flax module's output in the JAX script's
        `train_forward` at tiny (bf16 compute, f32 parameters), and in the
        SAM2 language decode at Hiera-L (`jax.eval_shape`, so nothing runs);
    PYTHONHASHSEED=N python tests/probe_f32_modules.py updates [--f32_sam]
        the port's train CLI and JAX's `build_train_step` on the batches of
        `tests/test_torch_train_cli.py::test_cli_loss_trace_matches_jax_train_step`
        (tiny, 3 steps, lr 1e-3), and the relative L2 of the port's update
        (master minus start) against JAX's for the LM, its lm_head, the
        SAM2 mask decoder and text_hidden_fcs; `--f32_sam` holds the whole
        of SAM2 in f32 (the frozen image encoder too, as JAX computes it).

Prints JSON lines. Imports JAX; the hash seed picks the dummy tokenizer's
ids, so set PYTHONHASHSEED to repeat a run.
"""
import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def output_dtypes(fn, *args):
    """{module path: sorted dtypes of its outputs} of a flax apply with
    captured intermediates, traced by `jax.eval_shape`."""
    import flax
    import jax

    _, inter = jax.eval_shape(fn, *args)
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(inter["intermediates"]), sep="/")
    return {k.rsplit("/__call__", 1)[0]: sorted({str(x.dtype) for x in jax.tree.leaves(v)})
            for k, v in sorted(flat.items())}


def dtypes() -> None:
    import jax
    import jax.numpy as jnp

    import test_torch_train_cli as T
    from rga3_tpu.models.sam2.config import SAM2_HIERA_L
    from rga3_tpu.models.sam2.model import Sam2Model
    from rga3_tpu_torch.data.processor import QwenVLProcessor
    from rga3_tpu_torch.tools.synth_trees import write_train_tree
    from rga3_tpu_torch.train import __main__ as cli

    with tempfile.TemporaryDirectory() as tmp:
        tree = write_train_tree(os.path.join(tmp, "tree"), ("mevis", "reason_seg"), seed=1)
        batch = cli.AccumBatches(
            T.dataset(tree), QwenVLProcessor.from_pretrained("dummy"), T.port_model().cfg,
            cli.parse_args(T.cli_args(tree, os.path.join(tmp, "ck"), "--micro_batch_size", "2",
                                      "--grad_accum_steps", "1")), 0)(0)
    jm, cfg = T.jax_model()
    params = T.jax_script().assemble_params(jm, cfg, {}, "float32")

    def train(p, b):
        return jm.apply(p, *(b[k] for k in T.TRAIN_KEYS), pixel_patches=b["pixel_patches"],
                        vision_layout={k: b[f"vl_{k}"] for k in T.VL_KEYS},
                        compute_dtype=jnp.bfloat16, method=T.JaxUniGR.train_forward,
                        capture_intermediates=True, mutable=["intermediates"])

    for path, dts in output_dtypes(train, params, {k: v[0] for k, v in batch.items()}).items():
        print(json.dumps({"config": "tiny train_forward", "module": path, "dtypes": dts}))

    sam = Sam2Model(SAM2_HIERA_L)
    img = jax.ShapeDtypeStruct((1, 1024, 1024, 3), jnp.bfloat16)
    lang = jax.ShapeDtypeStruct((1, 1, 256), jnp.float32)
    sparams = jax.eval_shape(sam.init, jax.random.PRNGKey(0), img, lang)

    def decode(p, x, e):
        return sam.apply(p, x, e, method=lambda m, x, e: m.decode_frames_with_language(
            x, e, training=True, stop_backbone_grad=True),
            capture_intermediates=True, mutable=["intermediates"])

    for path, dts in output_dtypes(decode, sparams, img, lang).items():
        print(json.dumps({"config": "Hiera-L decode", "module": path, "dtypes": dts}))


def updates(f32_sam: bool) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import test_torch_train_cli as T
    from rga3_tpu_torch.convert import torch_state_dict_from_flax
    from rga3_tpu_torch.tools.synth_trees import write_train_tree
    from rga3_tpu_torch.train import __main__ as cli

    if f32_sam:
        real = cli.UniGR

        def f32_sam_unigr(*a, **k):
            m = real(*a, **k)
            m.grounding_encoder.float()
            return m

        cli.UniGR = f32_sam_unigr
    batches = []

    class Recording(cli.PrefetchLoader):
        def __next__(self):
            batches.append(super().__next__())
            return batches[-1]

    cli.PrefetchLoader = Recording
    with tempfile.TemporaryDirectory() as tmp:
        tree = write_train_tree(os.path.join(tmp, "tree"), ("mevis", "reason_seg"), seed=1)
        run = cli.main(T.cli_args(tree, os.path.join(tmp, "ck"), "--epochs", "1",
                                  "--steps_per_epoch", "3", "--micro_batch_size", "2",
                                  "--grad_accum_steps", "2", "--no_eval", "--lr", str(T.LR)))
    jm, cfg = T.jax_model()
    jax_params = T.jax_script().assemble_params(jm, cfg, {}, "float32")
    tcfg = T.JaxTrainConfig(lr=T.LR, epochs=1, steps_per_epoch=3, micro_batch_size=2,
                            grad_accum_steps=2, lora_r=8, lora_alpha=16.0, remat="dots")
    state, tx = T.jax_make_train_state(tcfg, jax_params)

    def loss_fn(p, b):
        return jm.apply(p, *(b[k] for k in T.TRAIN_KEYS), pixel_patches=b["pixel_patches"],
                        vision_layout={k: b[f"vl_{k}"] for k in T.VL_KEYS},
                        compute_dtype=jnp.bfloat16, method=T.JaxUniGR.train_forward)

    step = T.jax_build_train_step(loss_fn, tx, grad_accum_steps=2, donate=False)
    for b in batches:
        state, _ = step(state, b)
    opt = run["state"].opt
    start = torch_state_dict_from_flax(jax.tree.map(np.asarray, jax_params))
    want = torch_state_dict_from_flax(jax.tree.map(np.asarray, state.params))
    out = {"hash_seed": os.environ.get("PYTHONHASHSEED"), "f32_sam": f32_sam}
    for group, prefix in (("lm", "qwen."), ("lm_head", "qwen.lm.lm_head"),
                          ("decoder", "grounding_encoder.sam_mask_decoder."),
                          ("text_hidden_fcs", "text_hidden_fcs.")):
        names = [n for n in opt.params if n.startswith(prefix)]
        got = torch.cat([(opt.value(n).float() - start[n]).flatten() for n in names])
        ref = torch.cat([(want[n] - start[n]).flatten() for n in names])
        out[group] = float((got - ref).norm() / ref.norm())
    print(json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["dtypes", "updates"])
    ap.add_argument("--f32_sam", action="store_true")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.what == "dtypes":
        dtypes()
    else:
        updates(args.f32_sam)


if __name__ == "__main__":
    main()
