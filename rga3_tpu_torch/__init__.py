"""UniGR in PyTorch with hand-written CUDA kernels for NVIDIA Hopper: the
port of the JAX package `rga3_tpu`, which stays the reference.

Entry point of the ported slice: `evaluation.segmentor.UniGRSegmentor`
(`segment_video_multi`) over `models.unigr.UniGR`. Weights of the JAX
package load through `convert.torch_state_dict_from_flax`. Entry points run
on the CUDA device unless the caller passes `device="cpu"`.
"""
