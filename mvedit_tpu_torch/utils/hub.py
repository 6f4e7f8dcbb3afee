"""huggingface:// checkpoint-scheme resolution (offline-first).

A copy of `mvedit_tpu/utils/hub.py` (the port imports nothing of the JAX
package). Checkpoint references may use the HuggingFace scheme
(``huggingface://org/repo[/file]``); they resolve against the LOCAL
HuggingFace cache only:

  huggingface://org/repo                -> cached snapshot directory
  huggingface://org/repo/sub/file.bin   -> cached file path

Resolution order: ``huggingface_hub`` with ``local_files_only=True`` if the
library is importable, else a manual scan of the standard cache layout
(``$HF_HOME/hub/models--org--repo/snapshots/<rev>/...``). This environment
has zero egress, so a cache miss raises a clear, actionable error instead
of attempting a download.
"""
import glob
import os

__all__ = ["is_hub_path", "resolve_checkpoint"]

SCHEME = "huggingface://"


def is_hub_path(path) -> bool:
    return isinstance(path, str) and path.startswith(SCHEME)


def _cache_root():
    hf_home = os.environ.get(
        "HF_HOME", os.path.join(os.path.expanduser("~"), ".cache",
                                "huggingface"))
    return os.path.join(hf_home, "hub")


def _split(path):
    """'huggingface://org/repo[/file...]' -> (repo_id, filename|None)."""
    rest = path[len(SCHEME):].strip("/")
    parts = rest.split("/")
    if len(parts) < 2:
        raise ValueError(
            f"malformed huggingface:// path {path!r}: expected "
            "huggingface://org/repo[/filename]")
    repo_id = "/".join(parts[:2])
    filename = "/".join(parts[2:]) or None
    if filename is not None:
        # reject traversal before any resolution: '..' segments would let
        # 'huggingface://org/repo/../..' escape the snapshot directory
        norm = os.path.normpath(filename)
        if norm.startswith("..") or os.path.isabs(norm):
            raise ValueError(
                f"refusing path traversal in checkpoint filename "
                f"{filename!r} (escapes the snapshot directory)")
    return repo_id, filename


def _scan_cache(repo_id, filename):
    """Manual resolution against the standard HF cache tree.

    Prefers the snapshot ``refs/main`` points to (newest-mtime is a stale
    tiebreak when several revisions are cached), and rejects filenames
    whose normalized join escapes the snapshot directory (a URI like
    ``huggingface://org/repo/../..`` must not resolve outside the cache).
    """
    repo_dir = os.path.join(_cache_root(),
                            "models--" + repo_id.replace("/", "--"))
    snaps = sorted(glob.glob(os.path.join(repo_dir, "snapshots", "*")),
                   key=os.path.getmtime, reverse=True)
    ref_main = os.path.join(repo_dir, "refs", "main")
    if os.path.isfile(ref_main):
        try:
            with open(ref_main) as f:
                rev = f.read().strip()
            pinned = os.path.join(repo_dir, "snapshots", rev)
            if os.path.isdir(pinned):
                snaps = [pinned] + [s for s in snaps if s != pinned]
        except OSError:
            pass
    for snap in snaps:
        if filename:
            cand = os.path.normpath(os.path.join(snap, filename))
            if not cand.startswith(os.path.normpath(snap) + os.sep):
                raise ValueError(
                    f"refusing path traversal in checkpoint filename "
                    f"{filename!r} (escapes the snapshot directory)")
        else:
            cand = snap
        if os.path.exists(cand):
            return cand
    return None


def resolve_checkpoint(path):
    """Resolve a checkpoint reference to a local filesystem path.

    Plain local paths pass through unchanged; ``huggingface://`` paths are
    resolved offline (cache hit required — this deployment has no egress).
    """
    if not is_hub_path(path):
        return path
    repo_id, filename = _split(path)
    try:
        if filename:
            from huggingface_hub import hf_hub_download
            return hf_hub_download(repo_id, filename,
                                   local_files_only=True)
        from huggingface_hub import snapshot_download
        return snapshot_download(repo_id, local_files_only=True)
    except ImportError:
        pass  # no huggingface_hub: manual cache scan below
    except OSError:
        pass  # incl. the hub's LocalEntryNotFoundError (cache miss)
    found = _scan_cache(repo_id, filename)
    if found:
        return found
    raise FileNotFoundError(
        f"{path} is not in the local HuggingFace cache "
        f"({_cache_root()}) and this environment has no network egress. "
        f"Pre-populate the cache (or pass a local checkpoint_dir) and "
        f"retry.")
