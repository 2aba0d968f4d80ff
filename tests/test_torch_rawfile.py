"""The port's raw file against the reference's: the host modes (array,
csv, mmap) read the same values with the same accounting, and a dataset
on a device reads by tensor rows with the reference's accounting too."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import AQPEngine as RefEngine, IndexConfig as RefConfig
from repro.data import make_synthetic_dataset as ref_dataset
from repro.data.synthetic import exploration_path as ref_path
from repro_torch.core import AQPEngine, IndexConfig
from repro_torch.data import make_synthetic_dataset


def _pair(storage, tmp_path):
    kw = {}
    if storage == "mmap":
        kw = dict(mmap_dir=str(tmp_path / "ref"))
    ref = ref_dataset(n=20_000, seed=9, storage=storage, **kw)
    if storage == "mmap":
        kw = dict(mmap_dir=str(tmp_path / "port"))
    port = make_synthetic_dataset(n=20_000, seed=9, storage=storage,
                                  device=None, **kw)
    return ref, port


@pytest.mark.parametrize("storage", ["array", "csv", "mmap"])
def test_host_modes_read_and_account_like_the_reference(storage, tmp_path):
    ref, port = _pair(storage, tmp_path)
    assert port.storage == ref.storage and port.domain() == ref.domain()
    rows = np.random.default_rng(0).integers(0, 20_000, 5000)
    for attr in ("a0", "a1", "a3"):
        np.testing.assert_array_equal(port.read_values(attr, rows),
                                      ref.read_values(attr, rows))
        np.testing.assert_array_equal(port.read_all_unaccounted(attr),
                                      ref.read_all_unaccounted(attr))
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)


@pytest.mark.parametrize("storage", ["csv", "mmap"])
def test_np_engine_on_host_modes_equals_reference(storage, tmp_path):
    ref, port = _pair(storage, tmp_path)
    kw = dict(grid0=(8, 8), min_split_count=64, init_metadata_attrs=("a0",))
    e_ref = RefEngine(ref, RefConfig(**kw))
    e_port = AQPEngine(port, IndexConfig(backend="np", **kw))
    for w in ref_path(ref, n_queries=3, target_objects=2000):
        ra = dataclasses.asdict(e_ref.query(w, "mean", "a0", phi=0.01))
        rb = dataclasses.asdict(e_port.query(w, "mean", "a0", phi=0.01))
        ra.pop("eval_time_s")
        rb.pop("eval_time_s")
        assert ra == rb
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)


def test_device_columns_gather_by_tensor_rows():
    ref = ref_dataset(n=20_000, seed=9)
    dev = make_synthetic_dataset(n=20_000, seed=9, device="cpu")
    assert isinstance(dev.x, torch.Tensor) and dev.device.type == "cpu"
    rows = np.random.default_rng(1).integers(0, 20_000, 3000)
    got = dev.read_values("a2", torch.from_numpy(rows))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), ref.read_values("a2", rows))
    np.testing.assert_array_equal(dev.read_values("a2", rows),
                                  ref.read_values("a2", rows))
    assert dataclasses.asdict(dev.stats) == dataclasses.asdict(ref.stats)
    with pytest.raises(ValueError):
        make_synthetic_dataset(n=100, storage="csv", device="cpu")
