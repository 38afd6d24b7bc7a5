"""Shared fixtures of the benchmark's tests: tiny copies of the real cells
(the ``test/vit-tiny`` backbone: width 64, 2 layers, 2 heads), run on the
CPU, where the program computes in float32."""

from __future__ import annotations

import copy
import pathlib
import sys

import pytest

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from posebench.harness import manifest as M  # noqa: E402


def tiny(cell: M.Cell) -> M.Cell:
    """``cell`` with the tiny backbone and a small batch: the same traffic
    kind, fine-tune, input size, limits and metrics."""
    cell = copy.deepcopy(cell)
    hf = cell.config["hf_config"]
    hf.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=2)
    cell.config["program"]["model_name"] = "test/vit-tiny"
    tr = cell.traffic
    if cell.kind == "train_steps":
        tr.update(batch_size=2, profile_steps=2)
        if "unfreeze_last_n_layers" in tr["finetune"]:
            tr["finetune"] = {"unfreeze_last_n_layers": 1}
    else:
        tr.update(max_batch=2, frames=6, sample=3, sample_longest=1,
                  profile_requests=2)
    return cell


@pytest.fixture(scope="session")
def manifest() -> dict:
    return M.load_manifest(CHECKOUT)


@pytest.fixture(scope="session")
def cells(manifest) -> dict:
    return {w["name"]: M.load_cell(w["name"], CHECKOUT, manifest) for w in manifest["workloads"]}


@pytest.fixture
def cpu():
    import torch

    torch.manual_seed(0)
    return torch.device("cpu")


@pytest.fixture
def card():
    """The card, or a skip: the benchmark's card tests run only there."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
