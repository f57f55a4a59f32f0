"""JSONL request-loop CLI (port of api/cli.py): reads one JSON request a line
(the reference's input_demo.jsonl format) and prints each result.

    python -m fastertransformer4codefuse_tpu_torch.api.cli \\
        --ckpt_path /path/to/1-gpu --tokenizer_path /path/to/tokenizer \\
        --int8_mode 1 --input_file input_demo.jsonl

``--weight_bits 4 --group_size 128`` serves an int4 g128 checkpoint
(``.q4.bin`` + ``.s4g128.bin``). ``--serve`` submits every request line at
once through the handler's continuous-batching pool (``--paged_pages`` P:
paged KV with P pages of ``--page_size``) and prints each response as it
completes; without ``--input_file`` it reads requests from stdin until EOF.
``--serve --speculative_pool`` makes the pool a speculative one (dense KV;
``--spec_k`` drafts a verify): greedy requests flagged ``"speculative"``
ride it, every other request the static path.
``--serve --http PORT`` serves POST /predict instead (``api/http_server.py``).
The model runs on the card unless ``--device`` names another.

``--tensor_parallel N`` runs under ``torchrun --nproc_per_node N``: the ranks
serve in lockstep (``parallel/lockstep.py``). Rank 0 alone reads
``--input_file`` or stdin, or binds ``--http``, and prints; the other ranks
serve its requests with it until it closes (at the end of its input, or
when its HTTP server shuts down).
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import threading


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--tokenizer_path", type=str, required=True)
    parser.add_argument("--int8_mode", type=int, default=0)
    parser.add_argument("--tensor_parallel", type=int, default=1)
    parser.add_argument("--dtype", type=str, default="bf16")
    parser.add_argument(
        "--weight_bits", type=int, default=8, choices=(4, 8),
        help="4 serves a .q4.bin int4 checkpoint (needs --int8_mode >= 1)",
    )
    parser.add_argument(
        "--group_size", type=int, default=0,
        help="group-wise int4 scale granularity (0 = per-channel)",
    )
    parser.add_argument(
        "--kv_cache_dtype", type=str, default=None,
        help="e.g. int8 for the quantized KV cache",
    )
    parser.add_argument(
        "--quantize_embeddings", action="store_true",
        help="also quantize the embedding table and LM head (int8_mode=2 is the alias)",
    )
    parser.add_argument("--input_file", type=str, default=None)
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument(
        "--serve", action="store_true",
        help="continuous-batching server mode: all requests run concurrently through the "
        "slot pool; responses print in completion order",
    )
    parser.add_argument("--pool_slots", type=int, default=8)
    parser.add_argument("--pool_seq_len", type=int, default=2048)
    parser.add_argument("--prompt_bucket", type=int, default=128)
    parser.add_argument(
        "--paged_pages", type=int, default=0, metavar="P",
        help="with --serve: the paged KV pool (engine/paged_kv.py) with P pages of "
        "--page_size positions; 0 = dense per-slot slabs",
    )
    parser.add_argument("--page_size", type=int, default=256)
    parser.add_argument(
        "--speculative_pool", action="store_true",
        help="with --serve: the pool is a speculative-serving SpecPool (engine/spec_pool.py): "
        "greedy requests flagged speculative ride (k+1)-wide verify ticks, the rest the "
        "static path",
    )
    parser.add_argument("--spec_k", type=int, default=8)
    parser.add_argument(
        "--http", type=int, default=0, metavar="PORT",
        help="with --serve: serve POST /predict on this port instead of reading JSONL "
        "(api/http_server.py)",
    )
    parser.add_argument("--http_host", default="127.0.0.1")
    parser.add_argument(
        "--device", default=None,
        help="torch device of the model (default: the CUDA card; e.g. cpu)",
    )
    args = parser.parse_args(argv)
    if not args.serve and args.input_file is None:
        parser.error("--input_file is required (or use --serve with stdin)")

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    )

    from .handler import CodeFuseHandler

    pool = None
    if args.serve:
        pool = dict(max_slots=args.pool_slots, max_seq_len=args.pool_seq_len,
                    prompt_bucket=args.prompt_bucket)
        if args.paged_pages:
            pool["paged"] = dict(num_pages=args.paged_pages, page_size=args.page_size)
        if args.speculative_pool:
            pool.update(speculative=True, spec_k=args.spec_k)
    handler = CodeFuseHandler(
        ckpt_path=args.ckpt_path,
        tokenizer_path=args.tokenizer_path,
        int8_mode=args.int8_mode,
        tensor_parallel=args.tensor_parallel,
        dtype=args.dtype,
        weight_bits=args.weight_bits,
        group_size=args.group_size,
        kv_cache_dtype=args.kv_cache_dtype,
        quantize_embeddings=args.quantize_embeddings or None,
        pool=pool,
        device=args.device,
    )

    if not handler.lockstep.leader:
        handler.follow()  # rank 0 reads the requests; this rank serves them with it
        return
    if args.serve:
        if args.http:
            from .http_server import serve_forever

            try:
                serve_forever(handler, args.http_host, args.http)
            finally:
                handler.close()
        else:
            serve(handler, args)
        return

    try:
        with open(args.input_file) as f:
            requests = [json.loads(line.strip()) for line in f if line.strip()]
        for i, request_dict in enumerate(requests):
            code, err, result_map = handler.predict(request_dict, "cli")
            if code != 0:
                print(err)
                raise RuntimeError(err)
            print_response(i, request_dict, json.loads(result_map["res"]))
    finally:
        handler.close()


def print_response(req_idx, request_dict, res):
    print("#" * 50)
    print("- request %d\n%s" % (req_idx, json.dumps(request_dict, ensure_ascii=False, indent=4)))
    for batch_idx, beam_result in enumerate(res["generated_code"]):
        for beam_idx, result in enumerate(beam_result):
            print(("=" if beam_idx == 0 else "-") * 50)
            print("- batch_idx %d" % batch_idx)
            print("- beam_idx %d" % beam_idx)
            print("- result\n%s" % result)
    print("=" * 50)
    print("- latency %f" % res["latency"])
    print("- random_seed %s" % str(res["random_seed"]))


def serve(handler, args):
    """Continuous-batching loop: one thread per in-flight request (predict
    blocks on the pool); responses print in completion order, so a short
    request arriving behind a long one overtakes it inside the pool."""
    out_lock = threading.Lock()
    threads = []

    def run_one(i, request_dict):
        code, err, result_map = handler.predict(request_dict, f"serve-{i}")
        with out_lock:
            if code != 0:
                print(f"# request {i} failed:\n{err}", flush=True)
            else:
                print_response(i, request_dict, json.loads(result_map["res"]))

    source = open(args.input_file) if args.input_file else sys.stdin
    try:
        for i, line in enumerate(source):
            line = line.strip()
            if not line:
                continue
            t = threading.Thread(target=run_one, args=(i, json.loads(line)))
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
    finally:
        if args.input_file:
            source.close()
        handler.close()


if __name__ == "__main__":
    main()
