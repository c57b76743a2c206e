"""VTK XML export of SCF results (port of `dftk_tpu/io/vtk.py`, the same
bytes for the same arrays; counterpart of DFTK's save_scfres .vts
support via WriteVTK, `src/external/vtkfile.jl`).

Writes a .vts StructuredGrid file (ASCII, self-contained, no external
dependency) with the density (total + spin channels) and optionally the
local potential and real-space orbital densities on the FFT grid.  Readable
by ParaView / VisIt / pyvista.
"""
import numpy as np

from ..utils import to_numpy


def save_vts(filename, scfres, extra_fields=None):
    """Write scfres density (and any extra [n1,n2,n3] fields) as .vts."""
    from .scfres import _getter
    get = _getter(scfres)
    basis = get("basis")
    rho = to_numpy(get("rho"))

    fields = {"density": rho.sum(axis=0)}
    if rho.shape[0] == 2:
        fields["spin_density"] = rho[0] - rho[1]
        fields["density_up"] = rho[0]
        fields["density_dn"] = rho[1]
    if extra_fields:
        for name, arr in extra_fields.items():
            fields[name] = to_numpy(arr)

    write_vts(filename, basis.model.lattice, basis.fft_size, fields)


def write_vts(filename, lattice, fft_size, fields):
    """ASCII VTK StructuredGrid: point grid r = lattice @ (i/n1, j/n2, k/n3).

    fields: dict name -> [n1, n2, n3] real array (periodic cell, endpoint
    excluded; VTK extents are n-1 cells per axis).
    """
    n1, n2, n3 = fft_size
    lattice = np.asarray(lattice, dtype=float)

    # points in Fortran-style ordering (x fastest) as VTK expects
    fi = np.arange(n1) / n1
    fj = np.arange(n2) / n2
    fk = np.arange(n3) / n3
    I, J, K = np.meshgrid(fi, fj, fk, indexing="ij")
    frac = np.stack([I, J, K], axis=-1)                      # [n1,n2,n3,3]
    cart = np.einsum("ab,ijkb->ijka", lattice, frac)
    pts = cart.transpose(2, 1, 0, 3).reshape(-1, 3)          # k slowest→ x fastest

    def fmt(a, per_line=6):
        flat = np.asarray(a, dtype=float).ravel()
        lines = []
        for s in range(0, flat.size, per_line):
            lines.append(" ".join(f"{v:.10g}" for v in flat[s:s + per_line]))
        return "\n".join(lines)

    extent = f"0 {n1 - 1} 0 {n2 - 1} 0 {n3 - 1}"
    out = []
    out.append('<?xml version="1.0"?>')
    out.append('<VTKFile type="StructuredGrid" version="0.1" '
               'byte_order="LittleEndian">')
    out.append(f'  <StructuredGrid WholeExtent="{extent}">')
    out.append(f'    <Piece Extent="{extent}">')
    out.append('      <PointData Scalars="%s">' % next(iter(fields)))
    for name, arr in fields.items():
        arr = np.asarray(arr)
        assert arr.shape == tuple(fft_size), (name, arr.shape)
        out.append(f'        <DataArray type="Float64" Name="{name}" '
                   'format="ascii">')
        out.append(fmt(arr.transpose(2, 1, 0)))   # x fastest
        out.append('        </DataArray>')
    out.append('      </PointData>')
    out.append('      <Points>')
    out.append('        <DataArray type="Float64" NumberOfComponents="3" '
               'format="ascii">')
    out.append(fmt(pts))
    out.append('        </DataArray>')
    out.append('      </Points>')
    out.append('    </Piece>')
    out.append('  </StructuredGrid>')
    out.append('</VTKFile>')
    with open(filename, "w") as f:
        f.write("\n".join(out) + "\n")
