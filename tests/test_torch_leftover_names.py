"""The last top-level names of ported modules against their JAX functions:
``utils/io.write_data_to_disk`` (the same bytes), ``utils/conversions``'
five unit conversions (equal, on scalars and arrays), the ``LabelEncoder``
interface (both encoders' one-hot vectors), ``data/utils``'
``create_index_from_annotations`` and ``total_annotation_duration_ms``,
and ``ops/metrics.multiclass_f1`` (equal, and to sklearn where it is
installed, as tests/test_metrics.py pins JAX's)."""

from __future__ import annotations

import numpy as np
import pytest

from segma_tpu.annotation import AudioAnnotation as JaxAnnotation
from segma_tpu.data import utils as jutils
from segma_tpu.ops import metrics as jmetrics
from segma_tpu.utils import conversions as jconv
from segma_tpu.utils import encoders as jenc
from segma_tpu.utils import io as jio
from segma_tpu_torch.annotation import AudioAnnotation
from segma_tpu_torch.data import utils as tutils
from segma_tpu_torch.ops import metrics as tmetrics
from segma_tpu_torch.utils import conversions as tconv
from segma_tpu_torch.utils import encoders as tenc
from segma_tpu_torch.utils import io as tio

LABELS = ("KCHI", "OCH", "MAL", "FEM")


@pytest.mark.parametrize("shape", [(16_000,), (2, 8_000)])
def test_write_data_to_disk_writes_jax_s_bytes(tmp_path, shape):
    data = np.random.default_rng(0).uniform(-1.2, 1.2, shape).astype(np.float32)
    jio.write_data_to_disk(data, tmp_path / "jax.wav", sample_rate=8_000)
    tio.write_data_to_disk(data, tmp_path / "port", sample_rate=8_000)  # suffix added
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    info = tio.get_audio_info_np(tmp_path / "port.wav")
    assert (info.n_channels, info.sample_rate) == ((shape[0] if len(shape) == 2 else 1), 8_000)


@pytest.mark.parametrize("name", ["frames_to_milliseconds", "milliseconds_to_frames",
                                  "millisecond_to_second", "ms_to_s", "s_to_ms"])
def test_conversions_are_jax_s(name):
    values = [0, 1, 7.5, 1234.56, np.array([0.0, 20.0, 1e6 + 0.5])]
    for v in values:
        want, got = getattr(jconv, name)(v), getattr(tconv, name)(v)
        assert type(got) is type(want)
        np.testing.assert_array_equal(got, want)
    if "frames" in name:
        np.testing.assert_array_equal(getattr(tconv, name)(np.array([320.0]), sample_rate=8_000),
                                      getattr(jconv, name)(np.array([320.0]), sample_rate=8_000))


@pytest.mark.parametrize("kind", ["MultiLabelEncoder", "PowersetEncoder"])
def test_label_encoders_share_jax_s_interface(kind):
    jaxe, port = getattr(jenc, kind)(LABELS), getattr(tenc, kind)(LABELS)
    assert isinstance(port, tenc.LabelEncoder)
    abstract = {n for n in dir(jenc.LabelEncoder)
                if getattr(getattr(jenc.LabelEncoder, n), "__isabstractmethod__", False)}
    assert abstract == {n for n in dir(tenc.LabelEncoder)
                        if getattr(getattr(tenc.LabelEncoder, n), "__isabstractmethod__", False)}
    for labels in (["KCHI"], ["MAL", "OCH"], "FEM"):
        if kind == "MultiLabelEncoder" or len(labels) <= 2:
            np.testing.assert_array_equal(port.one_hot(labels), jaxe.one_hot(labels))
    for i in range(len(jaxe)):
        np.testing.assert_array_equal(port.i_to_one_hot(i), jaxe.i_to_one_hot(i))
        assert port(port.inv_transform(i)) == jaxe(jaxe.inv_transform(i)) == i
    with pytest.raises(TypeError):
        tenc.LabelEncoder()


def _annotations(module):
    rows = [("a", 0.0, 1.25, "KCHI"), ("a", 0.5, 2.0, "FEM"), ("a", 3.125, 0.375, "MAL")]
    return [module(*row) for row in rows]


def test_data_utils_are_jax_s():
    jann, ann = _annotations(JaxAnnotation), _annotations(AudioAnnotation)
    assert tutils.total_annotation_duration_ms(ann) == jutils.total_annotation_duration_ms(jann)
    got = tutils.create_index_from_annotations(ann, tenc.MultiLabelEncoder(LABELS))
    want = jutils.create_index_from_annotations(jann, jenc.MultiLabelEncoder(LABELS))
    for field in ("starts", "ends", "label_onehot", "labels"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    empty = tutils.create_index_from_annotations([], tenc.MultiLabelEncoder(LABELS))
    assert empty.label_onehot.shape == (0, len(LABELS))


@pytest.mark.parametrize("seed", [0, 1])
def test_multiclass_f1_is_jax_s(seed):
    rng = np.random.default_rng(seed)
    preds, targets = rng.integers(0, 5, 200), rng.integers(0, 5, 200)
    preds[preds == 4] = 3  # class 4 is never predicted
    want = jmetrics.multiclass_f1(preds, targets, 6)  # class 5 never occurs: F1 0
    np.testing.assert_array_equal(tmetrics.multiclass_f1(preds, targets, 6), want)
    sklearn = pytest.importorskip("sklearn.metrics")
    np.testing.assert_allclose(
        want, sklearn.f1_score(targets, preds, labels=range(6), average=None, zero_division=0))
