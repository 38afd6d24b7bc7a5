"""Pretrained weights from the local Hugging Face hub cache, read without
``transformers``, ``huggingface_hub`` or ``safetensors``.

The port's counterpart of what the JAX package reads through
``transformers.Dinov2Model.from_pretrained(name, local_files_only=True)``
(``dino_pose_tpu/models/registry.py:_load_pretrained_dinov2``): the cache
that ``huggingface_hub`` fills, in its own layout, and nothing downloaded.

- The cache root: ``HF_HUB_CACHE`` (or the older ``HUGGINGFACE_HUB_CACHE``),
  else ``$HF_HOME/hub``, else ``$XDG_CACHE_HOME/huggingface/hub``, else
  ``~/.cache/huggingface/hub``; read at call time.
- A model ``org/name`` lives in ``models--org--name``: ``refs/main`` holds
  the commit whose files sit in ``snapshots/<commit>/``.
- The weights file, in ``from_pretrained``'s order: ``model.safetensors``,
  its sharded form ``model.safetensors.index.json``, ``pytorch_model.bin``
  (loaded with ``weights_only=True``), its sharded form
  ``pytorch_model.bin.index.json``.

Every tensor comes back as f32 on the CPU, as the JAX package casts the
weights to its f32 parameters, under the bare ``Dinov2Model`` key names:
a leading ``dinov2.`` (the base-model prefix of HF's task models) is
stripped, as ``from_pretrained`` strips it. An absent or unreadable entry
raises ``OSError``.
"""

from __future__ import annotations

import json
import os
import pickle

import torch

SAFE_WEIGHTS = "model.safetensors"
TORCH_WEIGHTS = "pytorch_model.bin"
INDEX_SUFFIX = ".index.json"
BASE_PREFIX = "dinov2."

# safetensors' dtype names (the little-endian types torch can view).
_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}

# HF Dinov2Config's defaults: what from_pretrained assumes for a field that
# config.json leaves out.
DINOV2_CONFIG_DEFAULTS = {"hidden_size": 768, "num_hidden_layers": 12,
                          "num_attention_heads": 12, "patch_size": 14, "image_size": 224}


def hub_cache_dir() -> str:
    """The hub cache's root, resolved as ``huggingface_hub`` resolves it."""
    cache = os.environ.get("HF_HUB_CACHE") or os.environ.get("HUGGINGFACE_HUB_CACHE")
    if cache:
        return os.path.expanduser(cache)
    home = os.environ.get("HF_HOME") or os.path.join(
        os.environ.get("XDG_CACHE_HOME") or os.path.join("~", ".cache"), "huggingface")
    return os.path.join(os.path.expanduser(home), "hub")


def snapshot_dir(repo_id: str) -> str:
    """The snapshot folder of ``repo_id``'s ``main``: the commit that
    ``refs/main`` names (or a snapshot named ``main`` where no ref is kept,
    as ``huggingface_hub`` looks it up)."""
    repo = os.path.join(hub_cache_dir(), "models--" + repo_id.replace("/", "--"))
    revision = "main"
    ref = os.path.join(repo, "refs", revision)
    if os.path.isfile(ref):
        with open(ref) as f:
            revision = f.read().strip()
    snapshot = os.path.join(repo, "snapshots", revision)
    if not os.path.isdir(snapshot):
        raise OSError(f"{repo_id} is not in the hub cache {hub_cache_dir()} (no {snapshot})")
    return snapshot


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file: an 8-byte little-endian
    header length, a JSON header ``{name: {dtype, shape, data_offsets}}``,
    then the raw bytes, offsets counted from the header's end."""
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    if len(buf) < 8:
        raise OSError(f"{path}: truncated safetensors file")
    n = int.from_bytes(buf[:8], "little")
    try:
        header = json.loads(buf[8:8 + n].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as err:
        raise OSError(f"{path}: unreadable safetensors header ({err})") from None
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info.get("dtype"))
        start, end = info["data_offsets"]
        if dtype is None or 8 + n + end > len(buf):
            raise OSError(f"{path}: tensor {name} has dtype {info.get('dtype')} or lies past "
                          "the end of the file")
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - start, offset=8 + n + start)
        out[name] = raw.clone().view(dtype).reshape(info["shape"])
    return out


def _read_weights(path: str) -> dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    try:
        return torch.load(path, weights_only=True, map_location="cpu")
    except (RuntimeError, EOFError, ValueError, pickle.UnpicklingError) as err:
        raise OSError(f"{path}: unreadable torch weights ({err})") from None


def read_weights(snapshot: str) -> dict[str, torch.Tensor]:
    """The weights of a snapshot, as f32, the base-model prefix stripped."""
    for name in (SAFE_WEIGHTS, TORCH_WEIGHTS):
        single, index = os.path.join(snapshot, name), os.path.join(snapshot, name + INDEX_SUFFIX)
        if os.path.isfile(single):
            state = _read_weights(single)
            break
        if os.path.isfile(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            state = {}
            for shard in sorted(set(weight_map.values())):
                state.update(_read_weights(os.path.join(snapshot, shard)))
            break
    else:
        raise OSError(f"{snapshot} holds no {SAFE_WEIGHTS}, {TORCH_WEIGHTS} or their "
                      "sharded index")
    return {(k[len(BASE_PREFIX):] if k.startswith(BASE_PREFIX) else k): v.float()
            for k, v in state.items() if v.is_floating_point()}


def check_dinov2_config(config: dict, expected: dict, repo_id: str) -> None:
    """Raise ``ValueError`` naming the first field of ``expected``
    (``hidden_size``, ``num_hidden_layers``, ``num_attention_heads``,
    ``patch_size``, ``image_size``) whose value in ``config`` differs; a
    field that ``config`` leaves out takes HF's default."""
    for field, want in expected.items():
        got = config.get(field, DINOV2_CONFIG_DEFAULTS.get(field))
        if got != want:
            raise ValueError(f"{repo_id}: the cached config.json has {field}={got}, "
                             f"the registry's preset {want}")


def load_dinov2(repo_id: str, expected: dict) -> dict[str, torch.Tensor]:
    """The cached ``Dinov2Model`` weights of ``repo_id`` (bare HF keys, f32,
    CPU), after its ``config.json`` is held to ``expected``. Raises
    ``OSError`` when the cache lacks the entry, its snapshot, its config or
    its weights, or cannot read them; ``ValueError`` on another shape."""
    snapshot = snapshot_dir(repo_id)
    path = os.path.join(snapshot, "config.json")
    if not os.path.isfile(path):
        raise OSError(f"{snapshot} holds no config.json")
    try:
        with open(path) as f:
            config = json.load(f)
    except json.JSONDecodeError as err:
        raise OSError(f"{path} is unreadable ({err})") from None
    check_dinov2_config(config, expected, repo_id)
    try:
        return read_weights(snapshot)
    except (KeyError, TypeError, RuntimeError, json.JSONDecodeError) as err:
        raise OSError(f"{snapshot}: unreadable weights ({type(err).__name__}: {err})") from None
