"""At-scale single-card generation demo (BASELINE config #5, one card).

Port of scripts/generate_at_scale.py. Runs the dataset factory over
>= 100k frames at device rate three ways and writes
<results-dir>/at_scale_generation.json:

  1. digest-manifest materialization (only per-chunk digests leave the
     card; manifest + seeded generators = the materialization recipe),
     with a regenerate-and-verify check on one chunk;
  2. fused generate->train on the CNN (end-to-end samples/s with the
     gradient update as the consumer; no storage in the loop), float32 and
     bf16;
  3. the native .ce5g codec's host write rate on one real materialized
     chunk (the storage half, measured on this host's cores).

The file's ``backend`` is the card's name and power limit (``cpu`` on
the CPU), so its rates are never read as another device's. See
ce5g_torch/data/atscale.py for the design.

    python -m ce5g_torch.cli.generate_at_scale --output-dir DIR --results-dir DIR
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import torch

from ..data import DatasetGenerator, generate_digest_split, online_train, verify_digest_chunk
from ..data.ce5g_format import write_ce5g
from ._common import card_label, load_cfg, make_parser, parse


def build_parser():
    parser = make_parser(__doc__)
    parser.add_argument("--samples", type=int, default=131072)
    parser.add_argument("--chunk-size", type=int, default=2048)
    parser.add_argument("--online-samples", type=int, default=131072)
    parser.add_argument("--online-batch", type=int, default=512)
    parser.add_argument("--steps-per-dispatch", type=int, default=16,
                        help="online steps whose losses are fetched at once")
    parser.add_argument("--skip-online", action="store_true")
    parser.add_argument("--skip-codec", action="store_true")
    parser.add_argument("--codec-chunk", type=int, default=256,
                        help="samples in the codec-probe chunk")
    parser.add_argument("--verify-chunk", type=int, default=None,
                        help="chunk index to regenerate+verify "
                        "(default: middle chunk)")
    parser.add_argument("--output-dir", required=True,
                        help="directory for the digest manifest and the codec probe")
    parser.add_argument("--results-dir", required=True,
                        help="directory for at_scale_generation.json")
    return parser


def main(argv=None) -> int:
    args, dev = parse(build_parser(), argv)
    cfg = load_cfg(args)
    out = {"backend": card_label(dev),
           "config": {"samples": args.samples, "chunk_size": args.chunk_size}}

    manifest = generate_digest_split(
        cfg, args.output_dir, num_samples=args.samples,
        chunk_size=args.chunk_size, device=dev,
    )
    vchunk = (
        args.verify_chunk
        if args.verify_chunk is not None
        else manifest["num_chunks"] // 2
    )
    ok = verify_digest_chunk(cfg, manifest, vchunk, device=dev)
    print(f"verify chunk {vchunk}: {'PASS' if ok else 'FAIL'}")
    out["digest_run"] = {
        "samples": manifest["total"],
        "device_samples_per_second": manifest["device_samples_per_second"],
        "elapsed_s": manifest["elapsed_s"],
        "manifest": f"{args.output_dir}/{manifest['split']}_digest_manifest.json",
        "verified_chunk": vchunk,
        "verify_pass": bool(ok),
    }

    if not args.skip_online:
        for key, dtype in (("online_train", torch.float32), ("online_train_bf16", torch.bfloat16)):
            out[key] = online_train(
                cfg, "cnn", total_samples=args.online_samples,
                batch_size=args.online_batch, steps_per_dispatch=args.steps_per_dispatch,
                dtype=dtype, device=dev,
            )

    if not args.skip_codec:
        # the storage half: materialize ONE chunk, then time the native
        # codec writing it repeatedly
        probe_cfg = dataclasses.replace(
            cfg, dataset=dataclasses.replace(cfg.dataset, chunk_size=args.codec_chunk))
        gen = DatasetGenerator(probe_cfg, args.output_dir, device=dev)
        arrays = gen._run_chunk("atscale", 0, args.codec_chunk)
        nbytes = sum(v.nbytes for v in arrays.values())
        p = Path(args.output_dir) / "codec_probe.ce5g"
        write_ce5g(p, arrays)  # warm (thread pool, page cache)
        reps, t0 = 3, time.perf_counter()
        for _ in range(reps):
            write_ce5g(p, arrays)
        dt = (time.perf_counter() - t0) / reps
        p.unlink()
        out["codec_write"] = {
            "chunk_samples": args.codec_chunk,
            "chunk_mb": nbytes / 1e6,
            "write_mb_per_s": nbytes / 1e6 / dt,
            "write_samples_per_s": args.codec_chunk / dt,
            "note": "host-side .ce5g write rate (threaded native codec, "
            "this host's cores); scales with cores on a deployment host",
        }
        print(
            f"codec: {out['codec_write']['write_mb_per_s']:.0f} MB/s "
            f"({out['codec_write']['write_samples_per_s']:.0f} samples/s)"
        )

    rp = Path(args.results_dir) / "at_scale_generation.json"
    rp.parent.mkdir(parents=True, exist_ok=True)
    rp.write_text(json.dumps(out, indent=2))
    print(f"wrote {rp}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
