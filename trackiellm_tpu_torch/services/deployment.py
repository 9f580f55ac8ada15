"""Deployment: version checking + verified package installation.

Parity target: the Rust ``deployment`` crate — DeploymentService with
version_checker (remote update query) and package_manager (download,
verify signature, install) (reference: src/deployment/src/lib.rs:11-17).
Transports are injectable (zero-egress environment, like the
reference's simulated endpoints); verification is real (SHA-256).
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Callable, Dict, Optional, Tuple

from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError
from trackiellm_tpu_torch.utils.logging import get_logger

log = get_logger("services.deployment")


def parse_version(v: str) -> Tuple[int, ...]:
    try:
        return tuple(int(p) for p in v.strip().lstrip("v").split("."))
    except ValueError as e:
        raise TrackieError(ErrorCode.INVALID_ARGUMENT,
                           f"bad version {v!r}") from e


class VersionChecker:
    """Compares the running version against a remote manifest."""

    def __init__(self, current_version: str,
                 query_fn: Optional[Callable[[], Dict]] = None):
        self.current_version = current_version
        self._query = query_fn  # returns {"version": ..., "sha256": ...,}

    def check(self) -> Optional[Dict]:
        """Returns the update manifest if newer, else None."""
        if self._query is None:
            return None
        manifest = self._query()
        if parse_version(manifest["version"]) > parse_version(
                self.current_version):
            return manifest
        return None


class PackageManager:
    """Download -> verify -> atomically install."""

    def __init__(self, install_dir: str,
                 download_fn: Optional[Callable[[str], bytes]] = None):
        self.install_dir = install_dir
        self._download = download_fn

    def install(self, manifest: Dict) -> str:
        """manifest: {"version", "url", "sha256", "filename"}. Returns
        the installed path. Refuses on digest mismatch."""
        if self._download is None:
            raise TrackieError(ErrorCode.NOT_IMPLEMENTED,
                               "no download transport configured")
        blob = self._download(manifest["url"])
        digest = hashlib.sha256(blob).hexdigest()
        if digest != manifest["sha256"]:
            raise TrackieError(
                ErrorCode.SECURITY_ERROR,
                f"package digest mismatch: {digest} != {manifest['sha256']}")
        os.makedirs(self.install_dir, exist_ok=True)
        dest = os.path.join(self.install_dir,
                            manifest.get("filename",
                                         f"pkg-{manifest['version']}"))
        fd, tmp = tempfile.mkstemp(dir=self.install_dir)
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, dest)
        log.info("installed %s (%d bytes)", dest, len(blob))
        return dest


class DeploymentService:
    def __init__(self, current_version: str, install_dir: str,
                 query_fn=None, download_fn=None):
        self.checker = VersionChecker(current_version, query_fn)
        self.packages = PackageManager(install_dir, download_fn)

    def update_if_available(self) -> Optional[str]:
        manifest = self.checker.check()
        if manifest is None:
            return None
        return self.packages.install(manifest)
