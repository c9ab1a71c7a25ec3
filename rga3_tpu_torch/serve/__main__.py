"""Start the UniGR demo server on the card, counterpart of
`scripts/serve_app.py`:

    python -m rga3_tpu_torch.serve --model_dir <dir> [--sam_pretrained <pt>] \
        [--model_size 7b] [--int4 | --int8 [--w8a8]] [--kv-int8] \
        [--draft_dir <dir> --spec_k 4] [--qa_batch_window_ms 30] [--port 7860]

The model flags are `models.unigr.build`'s. `--draft_dir` (a
Qwen2.5-VL-3B directory, or `dummy`; the tiny config with `--model_size
tiny`) is kept unquantized and makes QA decode speculatively. Without `--model_dir` the server answers with stubs.
`build_service(args)` builds the `UniGRService` that `main` serves.
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence

from ..data.video import load_frames_from_video
from ..evaluation.segmentor import UniGRChat, UniGRSegmentor
from ..models.unigr.build import add_draft_args, add_model_args, build_draft, build_model
from .app import UniGRService, serve


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_model_args(p)
    add_draft_args(p)
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--qa_batch_window_ms", type=int, default=0,
                   help="> 0 coalesces concurrent QA requests into one answer_batch call, "
                   "adding up to this much latency a request")
    p.add_argument("--qa_max_batch", type=int, default=4)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    return p.parse_args(argv)


def build_service(args, load_video: Callable = load_frames_from_video) -> UniGRService:
    """The service of `args`: no models without `--model_dir`."""
    kw = dict(qa_batch_window_ms=args.qa_batch_window_ms, qa_max_batch=args.qa_max_batch,
              load_video=load_video)
    if not args.model_dir:
        return UniGRService(**kw)
    model, proc = build_model(args)
    draft = None
    if args.draft_dir:
        draft = build_draft(args, model.device, model.dtype)
    chat = UniGRChat(model, proc, max_new_tokens=args.max_new_tokens, draft_model=draft,
                     spec_k=args.spec_k)
    return UniGRService(chat=chat, segmentor=UniGRSegmentor(model, proc, num_frames_mllm=8),
                        **kw)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    service = build_service(args)
    print(f"serving on {args.host}:{args.port}", flush=True)
    serve(service, port=args.port, host=args.host)


if __name__ == "__main__":
    main()
