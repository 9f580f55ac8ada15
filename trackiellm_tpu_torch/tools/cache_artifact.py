"""The built kernel library as a deployable artifact.

In the port, a fresh process's cold start is the nvcc build of the CUDA
kernel library (``ops/_build.py``) and the g++ build of the native runtime
(``ffi/native.py``); each lands in the build directory under a hash of its
sources and flags. This tool packs those directories into a tarball once,
and ``restore`` puts them into another host's (or a reset device's) build
directory, so that its first kernel call loads the library with no nvcc
run. Nothing is compiled per shape in the port, so nothing else is cached.

    python -m trackiellm_tpu_torch.tools.cache_artifact pack -o kernels.tar.gz
    python -m trackiellm_tpu_torch.tools.cache_artifact restore kernels.tar.gz
    python -m trackiellm_tpu_torch.tools.cache_artifact info kernels.tar.gz

``--cache-dir`` names the build directory (default ``$TRACKIE_BUILD_DIR``,
else ``trackiellm_tpu_torch/_build``). The manifest records torch, its CUDA
runtime, nvcc, the flags and the source hashes; ``restore`` warns when the
host differs: a library of other sources is keyed under another hash, so
this checkout does not find it and builds anew.

Port of ``tools/cache_artifact.py``.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tarfile
import tempfile
import time
from typing import List, Optional

import torch

from trackiellm_tpu_torch.ffi import native
from trackiellm_tpu_torch.ops import _build

MANIFEST = "MANIFEST.json"
# Manifest keys whose difference from the host's is warned about.
CHECKED = ("torch", "cuda_runtime", "nvcc", "kernel_digest")


def _nvcc_version() -> Optional[str]:
    """nvcc's release line, or None where there is no nvcc."""
    try:
        out = subprocess.run([_build._nvcc(), "--version"],
                             capture_output=True, text=True, timeout=60)
    except (_build.KernelBuildError, OSError, subprocess.SubprocessError):
        return None
    lines = [ln for ln in out.stdout.splitlines() if "release" in ln]
    return lines[-1].strip() if lines else None


def manifest() -> dict:
    """This host's toolchain and this checkout's source hashes."""
    return {
        "torch": torch.__version__,
        "cuda_runtime": torch.version.cuda,
        "nvcc": _nvcc_version(),
        "nvcc_flags": list(_build.NVCC_FLAGS),
        "kernel_digest": _build._digest(),
        "gxx_flags": list(native.GXX_FLAGS),
        "native_digest": native._digest(),
        "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }


def _root(cache_dir: Optional[str]) -> pathlib.Path:
    return pathlib.Path(cache_dir) if cache_dir else _build.BUILD_ROOT


def pack(out: str, cache_dir: Optional[str] = None) -> dict:
    """Tar the kernel library's directory (and the native runtime's, when
    built) of this checkout's sources, with the manifest."""
    root = _root(cache_dir)
    kernels = _build.library_path(root)
    if not kernels.exists():
        raise SystemExit(f"no kernel library at {kernels}: run `python -m "
                         "trackiellm_tpu_torch precompile` first")
    dirs = [kernels.parent]
    if native.library_path(root).exists():
        dirs.append(native.library_path(root).parent)
    entries: List[str] = []
    man = manifest()
    with tarfile.open(out, "w:gz") as tf:
        for d in dirs:
            for f in sorted(d.iterdir()):
                if f.is_file():
                    name = str(f.relative_to(root))
                    tf.add(str(f), arcname=name)
                    entries.append(name)
        man["entries"] = entries
        blob = json.dumps(man, indent=1).encode()
        info = tarfile.TarInfo(MANIFEST)
        info.size = len(blob)
        tf.addfile(info, io.BytesIO(blob))
    out_info = {"packed": out, "bytes": os.path.getsize(out), **man}
    print(json.dumps(out_info))
    return out_info


def read_manifest(artifact: str) -> dict:
    with tarfile.open(artifact, "r:gz") as tf:
        try:
            f = tf.extractfile(MANIFEST)
        except KeyError:
            return {}
        return json.loads(f.read()) if f else {}


def mismatches(man: dict, host: dict) -> List[str]:
    """The manifest's checked keys that differ from the host's. A host
    without nvcc is no mismatch: loading a built library needs none."""
    return [k for k in CHECKED
            if man.get(k) and host.get(k) and man[k] != host[k]]


def _member_path(root: pathlib.Path, name: str) -> pathlib.Path:
    rel = pathlib.PurePosixPath(name)
    if rel.is_absolute() or ".." in rel.parts or len(rel.parts) != 2:
        raise SystemExit(f"refusing artifact member {name!r}")
    return root.joinpath(*rel.parts)


def restore(artifact: str, cache_dir: Optional[str] = None) -> dict:
    """Unpack the libraries into the build directory, each file written
    beside its target and renamed into place. Warns on stderr where the
    manifest and this host differ."""
    root = _root(cache_dir)
    man = read_manifest(artifact)
    host = manifest()
    for key in mismatches(man, host):
        print(f"WARNING: artifact built with {key}={man[key]} but this "
              f"host has {host[key]}"
              + (": the library is keyed on its sources' hash, so this "
                 "checkout will not find it and builds anew"
                 if key == "kernel_digest" else
                 ": the library may fail to load; rebuild the artifact on "
                 "a matching toolchain"), file=sys.stderr)
    n = 0
    with tarfile.open(artifact, "r:gz") as tf:
        for m in tf.getmembers():
            if m.name == MANIFEST or not m.isfile():
                continue
            dest = _member_path(root, m.name)
            dest.parent.mkdir(parents=True, exist_ok=True)
            with tempfile.NamedTemporaryFile(dir=dest.parent,
                                             delete=False) as tmp:
                shutil.copyfileobj(tf.extractfile(m), tmp)
            os.chmod(tmp.name, m.mode & 0o777)
            os.replace(tmp.name, dest)
            n += 1
    out = {"restored": n, "cache_dir": str(root), "artifact_manifest": man,
           "mismatches": mismatches(man, host)}
    print(json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m trackiellm_tpu_torch.tools.cache_artifact")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("pack")
    p.add_argument("-o", "--out", default="trackie_kernels.tar.gz")
    p.add_argument("--cache-dir", default=None)
    p = sub.add_parser("restore")
    p.add_argument("artifact")
    p.add_argument("--cache-dir", default=None)
    p = sub.add_parser("info")
    p.add_argument("artifact")
    args = ap.parse_args(argv)
    if args.cmd == "pack":
        pack(args.out, args.cache_dir)
    elif args.cmd == "restore":
        restore(args.artifact, args.cache_dir)
    else:
        print(json.dumps(read_manifest(args.artifact), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
