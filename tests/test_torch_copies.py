"""PyTorch port, the fields' copies between host and device
(``emg3d_tpu_torch.copies``) on the CPU.

- a ``Field`` to the device and back is the same Field, bit for bit, in
  complex128, complex64 and float64 (the Laplace domain), and in place;
- Fields as lanes of one batched field, and back with a padding lane
  (None) left out; lanes that are all padding are not copied;
- a split iterate ``hi + lo`` in single precision, summed on the device
  in the Field's dtype, equals the sum of the two parts made on the host
  in float64, bit for bit;
- each copy is counted once (``h2d_copies``/``d2h_copies`` and their
  bytes), inside one ``emg3d.fields.*`` span a call; so are the copies
  of ``get_magnetic_field``.
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import emg3d_tpu_torch as t3
from emg3d_tpu_torch import copies, tracing

CPU = torch.device('cpu')


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """One torch thread and one BLAS thread: the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def grid():
    rng = np.random.default_rng(5)
    return t3.TensorMesh([rng.uniform(20, 40, n) for n in (5, 4, 3)],
                         origin=(0., 0., 0.))


def random_field(grid, dtype, seed):
    rng = np.random.default_rng(seed)
    field = t3.Field(grid, dtype=dtype)
    data = rng.standard_normal(field.field.size)
    if np.iscomplexobj(field.field):
        data = data + 1j * rng.standard_normal(field.field.size)
    field.field[:] = data
    return field


def growth(before):
    now = tracing.counts()
    return {k: now[k] - before[k] for k in
            ('h2d_copies', 'h2d_bytes', 'd2h_copies', 'd2h_bytes')}


@pytest.mark.parametrize('dtype', [np.complex128, np.complex64, np.float64])
def test_round_trip(grid, dtype):
    field = random_field(grid, dtype, 1)
    e = copies.field_to_device(field, CPU)
    assert all(c.is_contiguous() and c.dtype == e[0].dtype for c in e)
    assert [tuple(c.shape) for c in e] == [
        field.fx.shape, field.fy.shape, field.fz.shape]
    out = t3.Field(grid, dtype=dtype)
    data = out.field
    copies.field_to_host(e, out)
    assert out.field is data
    assert out.field.dtype == dtype
    assert np.array_equal(out.field, field.field)


def test_lanes_with_padding(grid):
    fields = [random_field(grid, np.complex128, k) for k in range(3)]
    e = copies.field_to_device(fields + [fields[-1]], CPU, torch.complex64)
    assert e[0].shape == (4, *fields[0].fx.shape)
    assert e[0].dtype == torch.complex64
    for k, f in enumerate(fields):
        assert np.array_equal(e[2][k].numpy(), f.fz.astype(np.complex64))
    out = [t3.Field(grid) for _ in range(3)]
    copies.field_to_host(e, out + [None])
    for o, f in zip(out, fields):
        assert np.array_equal(o.field, f.field.astype(np.complex64))
    before = tracing.counts()
    copies.field_to_host(e, [None] * 4)
    assert growth(before)['d2h_copies'] == 0


def test_split_iterate(grid):
    rng = np.random.default_rng(7)
    field = t3.Field(grid, frequency=1.0)
    hi, lo = [tuple(torch.from_numpy(
        (rng.standard_normal(s) + 1j * rng.standard_normal(s)) * scale
        ).to(torch.complex64) for s in (field.fx.shape, field.fy.shape,
                                        field.fz.shape))
        for scale in (1.0, 1e-7)]
    copies.field_to_host(hi, field, lo=lo)
    for name, h, low in zip(('fx', 'fy', 'fz'), hi, lo):
        host = (h.numpy().astype(np.complex128)
                + low.numpy().astype(np.complex128))
        assert np.array_equal(getattr(field, name), host)
    assert not np.array_equal(field.fx, hi[0].numpy())


def test_counted_once_in_one_span(grid):
    fields = [random_field(grid, np.complex128, k) for k in range(2)]
    nbytes = fields[0].field.nbytes
    tracing.clear()
    with tracing.recording():
        before = tracing.counts()
        e = copies.field_to_device(fields[0], CPU)
        assert growth(before) == dict(h2d_copies=3, h2d_bytes=nbytes,
                                      d2h_copies=0, d2h_bytes=0)
        before = tracing.counts()
        lanes = copies.field_to_device(fields, CPU, torch.complex128)
        assert growth(before) == dict(h2d_copies=6, h2d_bytes=2 * nbytes,
                                      d2h_copies=0, d2h_bytes=0)
        before = tracing.counts()
        copies.field_to_host(e, fields[0], lo=e)
        copies.field_to_host(lanes, fields)
        assert growth(before) == dict(h2d_copies=0, h2d_bytes=0,
                                      d2h_copies=6, d2h_bytes=3 * nbytes)
    names = [s.name for s in tracing.spans()]
    assert names == ['emg3d.fields.to_device'] * 2 + [
        'emg3d.fields.to_host'] * 2


def test_magnetic_field_counted(grid):
    model = t3.Model(grid, property_x=2.0)
    efield = random_field(grid, np.complex128, 3)
    efield._frequency = 1.0
    tracing.clear()
    with tracing.recording():
        before = tracing.counts()
        hfield = t3.get_magnetic_field(model, efield, device='cpu')
        counted = growth(before)
    # E's three components, the three widths and zeta in; H's three out.
    assert counted['h2d_copies'] == 7 and counted['d2h_copies'] == 3
    assert counted['d2h_bytes'] == hfield.field.nbytes
    assert [s.name for s in tracing.spans()] == [
        'emg3d.model.volume', 'emg3d.fields.to_device',
        'emg3d.fields.to_host']
