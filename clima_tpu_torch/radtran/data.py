"""Optical property data: containers, loaders, k-settings.

Mirrors the data model of ``src/radtran/clima_radtran_types.f90:23-141`` and
the load-time regridding of ``clima_radtran_types_create.f90``:

* k-tables: ``weights/log10P/T/wavelengths/log10k[ngauss,npress,ntemp,nwav]``
  (:1265-1378); wavelengths define the master grid.
* CIA/generic xsections: ``log10xs`` (1-D or [ntemp, nwav]) sampled on the
  file's own wavelength grid, regridded to the master bins with
  addpnt/inter2 sentinel semantics (:1090-1263).
* Rayleigh: A/B/Delta coefficients from rayleigh.yaml + the Vardavas closed
  form evaluated per master bin (:1048-1088).
* photolysis xsections: ``photoabsorption`` regridded with
  interp_discrete_to_bins/FillValue (:1407-1468).
* Mie particles: ``w0/qext/g0[nrad, nwav]`` regridded with
  interp_discrete_to_bins/Constant; radii um->cm (:734-866).
* water continuum: ``log10xs_H2O/log10xs_foreign[ntemp, nwav]`` (:868-1046).
* wavelength channels: ``bins.h5`` ``sol_wavl``/``ir_wavl`` subranges of the
  master grid (:226-270, 647-687).

A data directory is either a path on disk (HDF5 read with ``h5py``, YAML
with ``yaml``, both imported only when a file is read) or the same tree held
in memory as a mapping from relative path to parsed content: a dict of numpy
arrays for an ``.h5`` file, the parsed document for a ``.yaml`` file
(:func:`clima_tpu_torch.data.synthetic.make_template` builds one). The
regridding runs in float64 numpy on the host either way; the finished
tables then move to the requested device and dtype once
(:func:`optical_data_to`).
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from ..ops.rebin import addpnt, inter2, interp_discrete_to_bins
from ..physics.eqns import rayleigh_vardavas, weights_to_bins
from .. import constants as const
from ..utils.device import resolve_device
from ..utils.errors import ClimaException

__all__ = [
    "Ktable",
    "Xsection",
    "ParticleXsection",
    "WaterContinuum",
    "Ksettings",
    "OpticalData",
    "ChannelInfo",
    "DataDir",
    "load_optical_data",
    "load_channel",
    "read_stellar_flux",
    "optical_data_to",
    "optical_data_from_numpy",
]

RDELTA = 1.0e-4
# Far-end sentinel for addpnt padding. The reference uses huge(); a smaller
# finite value avoids float overflow in the cumulative-integral inter2 while
# still covering any conceivable wavelength grid.
HUGE = 1.0e30


@dataclasses.dataclass
class Ktable:
    sp_ind: int
    weights: object  # (ngauss,)
    weight_e: object  # (ngauss+1,)
    log10P: object  # (npress,) log10(bar)
    temp: object  # (ntemp,)
    log10k: object  # (ngauss, npress, ntemp, nw)

    @property
    def ngauss(self):
        return len(self.weights)


@dataclasses.dataclass
class Xsection:
    kind: str  # "CIA" | "rayleigh" | "absorption" | "photolysis"
    sp_inds: tuple
    dim: int  # 0 or 1
    xs_0d: Optional[object] = None  # (nw,) linear units
    temp: Optional[object] = None  # (ntemp,)
    log10_xs: Optional[object] = None  # (ntemp, nw)


@dataclasses.dataclass
class ParticleXsection:
    p_ind: int
    dat_name: str
    radii: object  # (nrad,) cm
    w0: object  # (nrad, nw)
    qext: object  # (nrad, nw)
    gt: object  # (nrad, nw)


@dataclasses.dataclass
class WaterContinuum:
    model: str
    LH2O: int
    temp: object  # (ntemp,)
    log10_xs_H2O: object  # (ntemp, nw)
    log10_xs_foreign: object  # (ntemp, nw)


@dataclasses.dataclass
class Ksettings:
    k_method: str
    nbin: int
    wbin: object  # (nbin,)
    wbin_e: object  # (nbin+1,)


@dataclasses.dataclass
class OpticalData:
    """Opacity tables on the master wavelength grid.

    Array fields are tensors on one device in one dtype (float64 numpy while
    a loader is still assembling them).
    """

    species_names: list
    particle_names: list
    nw: int
    wavl: object  # (nw+1,) nm
    freq: object  # (nw+1,) Hz
    kset: Ksettings
    k: list  # [Ktable]
    cia: list  # [Xsection]
    ray: list  # [Xsection]
    axs: list  # [Xsection]
    pxs: list  # [Xsection]
    part: list  # [ParticleXsection]
    cont: Optional[WaterContinuum]

    @property
    def nk(self):
        return len(self.k)

    def opacities2yaml(self) -> str:
        """Introspection string (clima_radtran_types.f90:328-426)."""
        out = []
        out.append(f"  k-method: {self.kset.k_method}")
        out.append("  opacities:")
        if self.k:
            names = ", ".join(self.species_names[kt.sp_ind] for kt in self.k)
            out.append(f"    k-distributions: [{names}]")
        if self.cia:
            names = ", ".join(
                f"{self.species_names[x.sp_inds[0]]}-{self.species_names[x.sp_inds[1]]}"
                for x in self.cia
            )
            out.append(f"    CIA: [{names}]")
        if self.ray:
            names = ", ".join(self.species_names[x.sp_inds[0]] for x in self.ray)
            out.append(f"    rayleigh: [{names}]")
        if self.pxs:
            names = ", ".join(self.species_names[x.sp_inds[0]] for x in self.pxs)
            out.append(f"    photolysis-xs: [{names}]")
        if self.cont is not None:
            out.append(f"    water-continuum: {self.cont.model}")
        if self.part:
            items = ", ".join(
                "{name: %s, data: %s}" % (self.particle_names[p.p_ind], p.dat_name)
                for p in self.part
            )
            out.append(f"    particle-xs: [{items}]")
        return "\n".join(out)


@dataclasses.dataclass
class ChannelInfo:
    """An RT channel: a subrange of the master grid. Host metadata (numpy)."""

    channel_type: str  # "solar" | "ir"
    ind_start: int  # 0-based bin index into master grid
    ind_end: int  # inclusive
    nw: int
    wavl: np.ndarray
    freq: np.ndarray


# ----------------------------------------------------------------------------
# Data directory access
# ----------------------------------------------------------------------------


class DataDir:
    """An opacity data directory on disk, or the same tree held in memory."""

    def __init__(self, root):
        self.root = root
        self.in_memory = isinstance(root, Mapping)

    def path(self, rel):
        return rel if self.in_memory else os.path.join(self.root, rel)

    def exists(self, rel):
        if self.in_memory:
            return rel in self.root
        return os.path.exists(os.path.join(self.root, rel))

    def h5(self, rel):
        """All datasets of an HDF5 file as {name: float64 ndarray}."""
        if self.in_memory:
            if rel not in self.root:
                raise ClimaException(f'"{rel}" is not in the in-memory data directory')
            content = self.root[rel]
        else:
            import h5py

            with h5py.File(os.path.join(self.root, rel), "r") as f:
                content = {k: f[k][()] for k in f.keys()}
        return {k: np.asarray(v, dtype=np.float64) for k, v in content.items()}

    def yaml(self, rel):
        if self.in_memory:
            return self.root[rel]
        import yaml

        with open(os.path.join(self.root, rel)) as f:
            return yaml.safe_load(f)


def _regrid_log10xs_rows(wavl, wav_f_nm, rows, fill):
    """addpnt sentinels + inter2 regrid of log10 xsection rows onto the bins."""
    out = np.zeros((rows.shape[0], len(wavl) - 1))
    for i in range(rows.shape[0]):
        x = wav_f_nm.copy()
        y = rows[i].copy()
        x, y = addpnt(x, y, x[0] * (1.0 - RDELTA), fill)
        x, y = addpnt(x, y, 0.0, fill)
        x, y = addpnt(x, y, x[-1] * (1.0 + RDELTA), fill)
        x, y = addpnt(x, y, HUGE, fill)
        out[i] = inter2(wavl, x, y)
    return out


def read_ktable(dd: DataDir, rel: str, sp_ind: int):
    """Read a k-distribution table; returns (Ktable, master wavl in nm)."""
    f = dd.h5(rel)
    weights = f["weights"]
    log10P = f["log10P"]
    temp = f["T"]
    wavl = f["wavelengths"] * 1.0e3  # um -> nm
    log10k = f["log10k"]
    kt = Ktable(
        sp_ind=sp_ind,
        weights=weights,
        weight_e=weights_to_bins(weights),
        log10P=log10P,
        temp=temp,
        log10k=log10k,
    )
    if log10k.shape != (len(weights), len(log10P), len(temp), len(wavl) - 1):
        raise ClimaException(f'"log10k" has the wrong shape in "{dd.path(rel)}"')
    return kt, wavl


def read_h5_xsection(dd: DataDir, rel: str, kind: str, sp_inds: tuple, wavl) -> Xsection:
    f = dd.h5(rel)
    if "log10xs" not in f:
        raise ClimaException(f'{dd.path(rel)}: dataset "log10xs" does not exist')
    log10xs = f["log10xs"]
    wav_f = f["wavelengths"] * 1.0e3  # um->nm
    dim = log10xs.ndim - 1
    if dim == 0:
        xs = _regrid_log10xs_rows(wavl, wav_f, log10xs[None, :], const.log10tiny)[0]
        return Xsection(kind=kind, sp_inds=sp_inds, dim=0, xs_0d=10.0**xs)
    elif dim == 1:
        rows = _regrid_log10xs_rows(wavl, wav_f, log10xs, const.log10tiny)
        return Xsection(kind=kind, sp_inds=sp_inds, dim=1, temp=f["T"], log10_xs=rows)
    raise ClimaException(f"{dd.path(rel)}: log10xs must be 1-D or 2-D")


def read_particle_xsection(dd: DataDir, rel: str, p_ind: int, dat_name: str, wavl) -> ParticleXsection:
    f = dd.h5(rel)
    wv = f["wavelengths"] * 1.0e3  # um->nm
    radii = f["radii"] / 1.0e4  # um->cm
    nrad = len(radii)
    nw = len(wavl) - 1
    out = {k: np.zeros((nrad, nw)) for k in ("w0", "qext", "g0")}
    for k, o in out.items():
        for i in range(nrad):
            o[i] = interp_discrete_to_bins(wavl, wv, f[k][i], "Constant")
    return ParticleXsection(
        p_ind=p_ind, dat_name=dat_name, radii=radii, w0=out["w0"], qext=out["qext"],
        gt=out["g0"],
    )


def read_water_continuum(model: str, dd: DataDir, rel: str, species_names, wavl) -> WaterContinuum:
    if "H2O" not in species_names:
        raise ClimaException('"H2O" must be a species to include the "continuum" opacity')
    if len(species_names) <= 1:
        raise ClimaException(
            'There must be more than 1 species in order to use the "continuum" opacity'
        )
    f = dd.h5(rel)
    wav_f = f["wavelengths"] * 1.0e3
    return WaterContinuum(
        model=model,
        LH2O=species_names.index("H2O"),
        temp=f["T"],
        log10_xs_H2O=_regrid_log10xs_rows(wavl, wav_f, f["log10xs_H2O"], const.log10tiny),
        log10_xs_foreign=_regrid_log10xs_rows(wavl, wav_f, f["log10xs_foreign"], const.log10tiny),
    )


def read_photolysis_xsection(dd: DataDir, rel: str, sp: str, sp_ind: int, wavl) -> Xsection:
    if not dd.exists(rel):
        raise ClimaException(f'Species "{sp}" does not have photolysis xsection data')
    f = dd.h5(rel)
    xs = np.log10(np.maximum(f["photoabsorption"], 1e-300))
    out = interp_discrete_to_bins(wavl, f["wavelengths"], xs, "FillValue", const.log10tiny)
    return Xsection(kind="photolysis", sp_inds=(sp_ind,), dim=0, xs_0d=10.0**out)


def read_rayleigh(root: dict, sp: str, sp_ind: int, wavl) -> Xsection:
    if sp not in root:
        raise ClimaException(f'Species "{sp}" has no Rayleigh data')
    d = root[sp]["data"]
    wbin_centers = wavl[:-1]
    xs = np.array(
        [
            float(rayleigh_vardavas(d["A"], d["B"], d["Delta"], w))
            for w in wbin_centers
        ]
    )
    return Xsection(kind="rayleigh", sp_inds=(sp_ind,), dim=0, xs_0d=xs)


def read_stellar_flux(star, wavl: np.ndarray) -> np.ndarray:
    """Stellar flux (wv nm, flux mW/m2/nm) -> per-bin mW/m2/Hz.

    ``star`` is a star file path (text, one header line) or its (n, 2)
    table. Mirrors ``read_stellar_flux`` (clima_radtran_types_create.f90:9-78).
    """
    data = np.loadtxt(star, skiprows=1) if isinstance(star, str) else np.asarray(star)
    wv = data[:, 0].astype(np.float64)
    fl = data[:, 1].astype(np.float64)
    x, y = addpnt(wv, fl, wv[0] * (1.0 - RDELTA), 0.0)
    x, y = addpnt(x, y, 0.0, 0.0)
    x, y = addpnt(x, y, x[-1] * (1.0 + RDELTA), 0.0)
    x, y = addpnt(x, y, HUGE, 0.0)
    flux = inter2(wavl, x, y)  # mW/m2/nm per bin
    wavl_av = 0.5 * (wavl[:-1] + wavl[1:])
    return flux * (((wavl_av * 1.0e-9) * wavl_av) / const.c_light)  # mW/m2/Hz


# ----------------------------------------------------------------------------
# Assembly (create_OpticalProperties, clima_radtran_types_create.f90:272-645)
# ----------------------------------------------------------------------------


def load_optical_data(datadir, species_names, particle_names, sop,
                      device=None, dtype=torch.float64) -> OpticalData:
    """Load and regrid every opacity source named by ``sop``.

    ``datadir`` is a path or an in-memory mapping (see :class:`DataDir`).
    Returns tables on ``device`` in ``dtype``; ``device`` None means the CUDA
    card (raises without one).
    """
    dd = datadir if isinstance(datadir, DataDir) else DataDir(datadir)
    species_names = list(species_names)
    particle_names = list(particle_names)

    # --- k-distributions ---
    if sop.k_distributions_bool:
        klist = [
            s for s in species_names if dd.exists(f"kdistributions/{s}.h5")
        ]
        if not klist:
            raise ClimaException(
                "No k-distribution data was found, but at least one k-distribution is needed."
            )
    elif sop.k_distributions:
        klist = list(sop.k_distributions)
    else:
        raise ClimaException(
            "You must specify at least one k-distribution in the settings file."
        )

    ktables = []
    wavl = None
    for s in klist:
        if s not in species_names:
            raise ClimaException(
                f'Species "{s}" in optical property "k-distributions" is not in the list of species.'
            )
        kt, wavl_s = read_ktable(dd, f"kdistributions/{s}.h5", species_names.index(s))
        if wavl is None:
            wavl = wavl_s
        else:
            if len(wavl_s) != len(wavl) or not np.allclose(wavl_s, wavl, rtol=1e-7):
                raise ClimaException(
                    f'Species "{s}" has wavelength bins that do not match other species'
                )
        ktables.append(kt)
    for kt in ktables[1:]:
        if kt.ngauss != ktables[0].ngauss or not np.allclose(
            kt.weights, ktables[0].weights, rtol=1e-12
        ):
            raise ClimaException("All k-coeff bin weights must match.")

    kset = Ksettings(
        k_method=sop.k_method,
        nbin=ktables[0].ngauss,
        wbin=ktables[0].weights,
        wbin_e=ktables[0].weight_e,
    )

    # --- CIA ---
    cia = []
    cia_names = []
    if sop.cia_bool:
        for s1 in species_names:
            for s2 in species_names:
                name = f"{s1}-{s2}"
                if dd.exists(f"CIA/{name}.h5") and not (
                    sop.water_continuum is not None and "H2O" in (s1, s2)
                ):
                    cia_names.append(name)
    elif sop.cia:
        cia_names = list(sop.cia)
    for name in cia_names:
        parts = _parse_cia_pair(name, species_names)
        cia.append(read_h5_xsection(dd, f"CIA/{name}.h5", "CIA", parts, wavl))
        if sop.water_continuum is not None and "H2O" in name.split("-"):
            raise ClimaException(
                f'Optical property "water-continuum" is set, but CIA "{name}" is also set.'
            )

    # --- Rayleigh ---
    ray = []
    if sop.rayleigh_bool or sop.rayleigh:
        rayroot = dd.yaml("rayleigh/rayleigh.yaml")
        if sop.rayleigh_bool:
            rlist = [s for s in rayroot.keys() if s in species_names]
        else:
            rlist = list(sop.rayleigh)
        for s in rlist:
            if s not in species_names:
                raise ClimaException(
                    f'Species "{s}" in optical property "rayleigh" is not in the list of species.'
                )
            ray.append(read_rayleigh(rayroot, s, species_names.index(s), wavl))

    # --- photolysis xsections ---
    pxs = []
    if sop.photolysis_bool:
        plist = [s for s in species_names if dd.exists(f"xsections/{s}.h5")]
    elif sop.photolysis_xs:
        plist = list(sop.photolysis_xs)
    else:
        plist = []
    for s in plist:
        if s not in species_names:
            raise ClimaException(
                f'Species "{s}" in optical property "photolysis-xs" is not in the list of species.'
            )
        pxs.append(
            read_photolysis_xsection(dd, f"xsections/{s}.h5", s, species_names.index(s), wavl)
        )

    # --- particles ---
    part = []
    if sop.particle_xs:
        for p in sop.particle_xs:
            if p["name"] not in particle_names:
                raise ClimaException(
                    f'Species "{p["name"]}" in optical property "particle-xs" is not in the list of particles.'
                )
            rel = f"aerosol_xsections/{p['dat']}/mie_{p['dat']}.h5"
            part.append(
                read_particle_xsection(dd, rel, particle_names.index(p["name"]), p["dat"], wavl)
            )

    # --- water continuum ---
    cont = None
    if sop.water_continuum is not None:
        rel = f"water_continuum/{sop.water_continuum}.h5"
        if not dd.exists(rel):
            raise ClimaException(f'Continuum "{sop.water_continuum}" is not avaliable.')
        cont = read_water_continuum(sop.water_continuum, dd, rel, species_names, wavl)

    freq = const.c_light / (wavl * 1.0e-9)
    host = OpticalData(
        species_names=species_names,
        particle_names=particle_names,
        nw=len(wavl) - 1,
        wavl=wavl,
        freq=freq,
        kset=kset,
        k=ktables,
        cia=cia,
        ray=ray,
        axs=[],
        pxs=pxs,
        part=part,
        cont=cont,
    )
    return optical_data_to(host, device, dtype)


def _parse_cia_pair(pair_str: str, species_names):
    """Parse 'A-B' into species indices (types_create.f90:689-732)."""
    matches = []
    for p in range(1, len(pair_str) - 1):
        if pair_str[p] != "-":
            continue
        left, right = pair_str[:p], pair_str[p + 1 :]
        if left in species_names and right in species_names:
            matches.append((species_names.index(left), species_names.index(right)))
    if len(matches) == 0:
        raise ClimaException(
            f'Could not parse CIA species pair "{pair_str}" into two known species.'
        )
    if len(matches) > 1:
        raise ClimaException(f'CIA species pair "{pair_str}" is ambiguous.')
    return matches[0]


def load_channel(datadir, channel_type: str, wavelength_bins_file, op: OpticalData) -> ChannelInfo:
    """Build an RT channel as a subrange of the master grid (types_create.f90:226-270).

    ``wavelength_bins_file`` (a path, or None for the datadir's
    ``kdistributions/bins.h5``) overrides the bins file.
    """
    dd = datadir if isinstance(datadir, DataDir) else DataDir(datadir)
    if wavelength_bins_file:
        dd, rel = DataDir(os.path.dirname(wavelength_bins_file)), os.path.basename(wavelength_bins_file)
    else:
        rel = "kdistributions/bins.h5"
    key = "sol_wavl" if channel_type == "solar" else "ir_wavl"
    wavl = dd.h5(rel)[key] * 1.0e3  # um->nm
    op_wavl = _host(op.wavl)
    ind1 = int(np.argmin(np.abs(wavl[0] - op_wavl)))
    ind2 = int(np.argmin(np.abs(wavl[-1] - op_wavl)))
    seg = op_wavl[ind1 : ind2 + 1]
    if len(wavl) != len(seg) or not np.allclose(wavl, seg, rtol=1e-7):
        raise ClimaException(
            f'The wavelength bins "{dd.path(rel)}" are not compatible with the k-distribution wavelength bins.'
        )
    freq = const.c_light / (wavl * 1.0e-9)
    return ChannelInfo(
        channel_type=channel_type,
        ind_start=ind1,
        ind_end=ind2 - 1,
        nw=len(wavl) - 1,
        wavl=wavl,
        freq=freq,
    )


# ----------------------------------------------------------------------------
# Moving tables between host numpy and a device
# ----------------------------------------------------------------------------


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


_CLASSES = {c.__name__: c for c in (Ktable, Xsection, ParticleXsection,
                                    WaterContinuum, Ksettings, OpticalData)}


def _convert(obj, device, dtype):
    if dataclasses.is_dataclass(obj):
        cls = _CLASSES[type(obj).__name__]
        return cls(**{f.name: _convert(getattr(obj, f.name), device, dtype)
                      for f in dataclasses.fields(cls)})
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return torch.tensor(_host(obj), dtype=dtype, device=device)
    if isinstance(obj, list):
        return [_convert(x, device, dtype) for x in obj]
    return obj


def optical_data_to(op, device=None, dtype=torch.float64) -> OpticalData:
    """Copy of ``op`` (any OpticalData with numpy or tensor arrays) whose
    array fields are tensors on ``device`` (None: the CUDA card) in ``dtype``."""
    return _convert(op, resolve_device(device), dtype)


def optical_data_from_numpy(op, ir, sol, device=None, dtype=torch.float64):
    """The port's (OpticalData, ir ChannelInfo, solar ChannelInfo) from tables
    loaded elsewhere as numpy dataclasses with the same field names (such as
    the JAX package's loaders), so that both packages compute on identical
    tables."""
    channel = lambda c: ChannelInfo(
        channel_type=c.channel_type, ind_start=int(c.ind_start), ind_end=int(c.ind_end),
        nw=int(c.nw), wavl=np.array(c.wavl, np.float64), freq=np.array(c.freq, np.float64),
    )
    return optical_data_to(op, device, dtype), channel(ir), channel(sol)
