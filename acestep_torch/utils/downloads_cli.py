"""`acestep-torch-download` entry point (reference: acestep-download)."""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from acestep_torch.utils.downloads import (REPO_IDS, ensure_model,
                                         verify_checkpoint, write_manifest)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Download / locate ACE-Step checkpoints")
    parser.add_argument("models", nargs="*",
                        default=["acestep-v15-turbo", "vae",
                                 "Qwen3-Embedding-0.6B"],
                        help=f"model names (known: {sorted(REPO_IDS)})")
    parser.add_argument("--root", default=None,
                        help="checkpoint root (default ./checkpoints)")
    parser.add_argument("--no-download", action="store_true",
                        help="only resolve locally")
    parser.add_argument("--source", default=None,
                        choices=["auto", "huggingface", "modelscope"],
                        help="download hub preference (default: "
                             "ACESTEP_DOWNLOAD_SOURCE env or reachability "
                             "probe; reference api_server.py:3282)")
    parser.add_argument("--verify", action="store_true",
                        help="check weight files against the SHA-256 "
                             "manifest (reference code-file hash sync)")
    parser.add_argument("--write-manifest", action="store_true",
                        help="(re)write the SHA-256 manifest for each model")
    args = parser.parse_args(argv)

    status = 0
    for name in args.models:
        try:
            source = None if args.source in (None, "auto") else args.source
            path = ensure_model(name, root=args.root,
                                allow_download=not args.no_download,
                                prefer_source=source)
            print(f"{name}: {path}")
            if args.write_manifest:
                manifest = write_manifest(path)
                print(f"{name}: manifest written ({len(manifest)} files)")
            if args.verify:
                bad = verify_checkpoint(path)
                if bad:
                    print(f"{name}: HASH MISMATCH in {bad}", file=sys.stderr)
                    status = 1
                else:
                    print(f"{name}: verified ok")
        except FileNotFoundError as e:
            print(f"{name}: MISSING\n{e}", file=sys.stderr)
            status = 1
        except RuntimeError as e:        # integrity verification failed
            print(f"{name}: {e}", file=sys.stderr)
            status = 1
    return status


if __name__ == "__main__":
    raise SystemExit(main())
