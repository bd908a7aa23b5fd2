"""3D mesh asset loading (counterpart of ``cheetah_tpu/utils/assets.py``).

Assets (.glb meshes of accelerator hardware) are looked up in the local
cache directory first, ``$CHEETAH_TPU_ASSETS`` (the JAX package's
variable, so that one cache can serve both) or
``~/.cache/cheetah_tpu_torch``, then downloaded from the desy-ml/3d-assets
repository into it. Without network access only the cache works: a
missing asset gives ``None``, and the caller warns.
"""

from __future__ import annotations

import os
from pathlib import Path

ASSET_REPOSITORY_URL = "https://raw.githubusercontent.com/desy-ml/3d-assets"


def asset_cache_directory() -> Path:
    override = os.environ.get("CHEETAH_TPU_ASSETS")
    if override:
        return Path(override)
    return Path.home() / ".cache" / "cheetah_tpu_torch"


def load_3d_asset(
    filename: str,
    branch_or_tag: str = "v1.2.0",
    show_download_progress: bool = True,
):
    """Load (and cache) a 3D mesh asset; ``None`` if it is unavailable or
    ``trimesh`` is not installed.

    :param filename: Asset file name, e.g. ``"quadrupole.glb"``.
    :param branch_or_tag: Version of the asset repository.
    """
    try:
        import trimesh
    except ImportError:
        return None

    cache_path = asset_cache_directory() / branch_or_tag / filename
    if not cache_path.is_file():
        import urllib.error
        import urllib.request

        try:
            cache_path.parent.mkdir(parents=True, exist_ok=True)
            url = f"{ASSET_REPOSITORY_URL}/{branch_or_tag}/{filename}"
            urllib.request.urlretrieve(url, cache_path)
        except (OSError, urllib.error.URLError):
            return None

    try:
        return trimesh.load_mesh(str(cache_path))
    except (OSError, ValueError):
        return None
