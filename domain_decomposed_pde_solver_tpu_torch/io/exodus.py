"""Pure-Python Exodus-II reader/writer over netCDF3.

Replaces the reference's use of the SEACAS ExodusII C API
(``ex_open``/``ex_create``/``ex_get_*``/``ex_put_*``, ``ExodusIO.hpp:88-114,
:1707-1966, :1972-2070``).  Exodus-II files are netCDF (the bundled meshes are
all netCDF3 classic), so ``scipy.io.netcdf_file`` suffices — no native
dependency, every MB stays on the host, and the reader hands back plain NumPy
arrays ready for device upload.

Supported schema (everything the reference touches, plus round-trip extras):
  dims    : num_nodes/num_dim/num_elem/num_el_blk/num_node_sets/num_side_sets,
            per-entity dims, time_step (unlimited), string-length dims
  vars    : coordx/coordy/coordz (or packed ``coord``), connect{i} (+elem_type
            attr), eb/ns/ss prop1+status+names, node_ns{i}, dist_fact_ns{i},
            elem_ss{i}/side_ss{i}/dist_fact_ss{i}, node_num_map/elem_num_map/
            elem_map, qa_records, info_records, coor_names,
            time_whole + vals_nod_var{k} + name_nod_var (solution output)
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import dataclasses

import numpy as np
from scipy.io import netcdf_file

from .mesh import ElemBlock, MeshModel, NodeSet, SideSet

__all__ = [
    "MeshSlice",
    "read_exodus_partial",
    "read_exodus_node_data",
    "read_exodus",
    "write_exodus",
    "ExodusSolutionWriter",
    "read_nodal_vars",
    "ExodusReadError",
]


class ExodusReadError(ValueError):
    """A file exists but is not a readable Exodus-II/netCDF3 mesh.

    Wraps the assorted low-level errors (scipy netcdf parse failures,
    short reads from truncated files, missing dimensions) with the file
    path, so callers and CLI users see one predictable exception type.
    A missing file still raises ``FileNotFoundError``."""


def _open_nc(path: str):
    try:
        return netcdf_file(path, "r", mmap=False)
    except FileNotFoundError:
        raise
    except Exception as e:  # scipy raises TypeError/ValueError/struct.error
        raise ExodusReadError(f"{path}: not a readable netCDF3 file ({e})") from e

_EX_VERSION = np.float32(8.03)


def _chars_to_str(arr: np.ndarray) -> str:
    """Decode a |S1 char array row into a Python string."""
    return arr.tobytes().split(b"\x00", 1)[0].decode("latin-1").rstrip()


def _get(nc, name, default=None):
    v = nc.variables.get(name)
    if v is None:
        return default
    data = np.array(v.data if hasattr(v, "data") else v[:])
    return data


@dataclasses.dataclass
class MeshSlice:
    """A block-distributed element slice of a mesh (per-host ingest).

    The multi-host analogue of the reference's element path, where every
    rank reads only its contiguous slice of the connectivity
    (``ExodusIO.hpp:781-828``) instead of the whole file.  Node ids in
    ``blocks[*].conn`` remain GLOBAL; ``node_ids`` lists the referenced
    global nodes (sorted) and ``coords`` carries only their coordinates.
    """

    part: int
    nparts: int
    elem_range: "tuple[int, int]"  # [lo, hi) global element ids
    blocks: "List[ElemBlock]"
    node_ids: np.ndarray  # (n_local_nodes,) sorted global node ids
    coords: np.ndarray  # (n_local_nodes, num_dim)
    num_nodes_global: int
    num_elem_global: int


def read_exodus_partial(path: str, part: int, nparts: int) -> MeshSlice:
    """Read only this part's contiguous element slice of the mesh.

    Elements are block-distributed across ``nparts`` in global order (the
    ``ExodusIO.hpp:781-828`` rule); connectivity is sliced with
    memory-mapped netCDF reads, so each host touches only its pages of the
    ``connect{i}`` variables plus the coordinates of referenced nodes —
    per-host IO scales with the slice, not the mesh.
    """
    if not (0 <= part < nparts):
        raise ValueError(f"part {part} out of range for nparts={nparts}")
    try:
        nc = netcdf_file(path, "r", mmap=True)
    except FileNotFoundError:
        raise
    except Exception as e:
        raise ExodusReadError(f"{path}: not a readable netCDF3 file ({e})") from e
    try:
        dims = nc.dimensions
        num_nodes = int(dims["num_nodes"])
        num_dim = int(dims["num_dim"])
        num_el_blk = int(dims.get("num_el_blk", 0) or 0)
        blk_sizes = [
            int(dims[f"num_el_in_blk{i + 1}"]) for i in range(num_el_blk)
        ]
        num_elem = int(sum(blk_sizes))
        per = -(-num_elem // nparts)
        lo = min(part * per, num_elem)
        hi = min(lo + per, num_elem)

        eb_ids = _get(nc, "eb_prop1")
        eb_ids = (
            eb_ids.astype(np.int64)
            if eb_ids is not None
            else np.arange(1, num_el_blk + 1)
        )
        blocks: List[ElemBlock] = []
        offset = 0
        for i in range(num_el_blk):
            b_lo = max(lo - offset, 0)
            b_hi = min(hi - offset, blk_sizes[i])
            offset += blk_sizes[i]
            if b_hi <= b_lo:
                continue
            cv = nc.variables[f"connect{i + 1}"]
            conn = np.array(cv[b_lo:b_hi], dtype=np.int64) - 1
            elem_type = (
                cv.elem_type.decode("latin-1").strip()
                if isinstance(getattr(cv, "elem_type", ""), bytes)
                else str(getattr(cv, "elem_type", "")).strip()
            )
            blocks.append(
                ElemBlock(
                    id=int(eb_ids[i]), elem_type=elem_type, conn=conn, name=""
                )
            )

        node_ids = (
            np.unique(np.concatenate([b.conn.reshape(-1) for b in blocks]))
            if blocks
            else np.zeros(0, np.int64)
        )
        if "coord" in nc.variables:
            cvar = nc.variables["coord"]
            coords = np.stack(
                [np.asarray(cvar[d][node_ids], dtype=np.float64)
                 for d in range(num_dim)],
                axis=1,
            )
        else:
            axes = []
            for ax in ("coordx", "coordy", "coordz")[:num_dim]:
                v = nc.variables.get(ax)
                axes.append(
                    np.zeros(node_ids.size)
                    if v is None
                    else np.asarray(v[:], dtype=np.float64)[node_ids]
                )
            coords = (
                np.stack(axes, axis=1)
                if axes
                else np.zeros((node_ids.size, 0))
            )
        return MeshSlice(
            part=part,
            nparts=nparts,
            elem_range=(lo, hi),
            blocks=blocks,
            node_ids=node_ids,
            coords=coords,
            num_nodes_global=num_nodes,
            num_elem_global=num_elem,
        )
    finally:
        try:
            nc.close()
        except Exception:
            pass


def read_exodus_node_data(path: str):
    """Read only the O(N) node-level data: ``(num_nodes, coords, node_sets)``.

    The per-host companion of :func:`read_exodus_partial` for distributed
    assembly: every host needs the coordinates (to compute the same
    deterministic RCB node partition with zero communication) and the
    nodesets (Dirichlet classification), but never the O(E) connectivity
    outside its own slice.  The reference accepts the same O(N)-per-rank
    node metadata cost (its author flags it at ``ExodusIO.hpp:155``).
    """
    nc = _open_nc(path)
    try:
        dims = nc.dimensions
        num_nodes = int(dims["num_nodes"])
        num_dim = int(dims["num_dim"])
        if "coord" in nc.variables:
            coords = np.array(nc.variables["coord"].data, dtype=np.float64).T
        else:
            axes = []
            for ax in ("coordx", "coordy", "coordz")[:num_dim]:
                arr = _get(nc, ax)
                axes.append(
                    np.zeros(num_nodes) if arr is None else arr.astype(np.float64)
                )
            coords = np.stack(axes, axis=1) if axes else np.zeros((num_nodes, 0))
        num_ns = int(dims.get("num_node_sets", 0) or 0)
        ns_ids = _get(nc, "ns_prop1")
        ns_ids = (
            ns_ids.astype(np.int64)
            if ns_ids is not None
            else np.arange(1, num_ns + 1)
        )
        node_sets: List[NodeSet] = []
        for i in range(num_ns):
            nodes = _get(nc, f"node_ns{i + 1}")
            nodes = (
                nodes.astype(np.int64) - 1
                if nodes is not None
                else np.zeros(0, np.int64)
            )
            node_sets.append(NodeSet(id=int(ns_ids[i]), nodes=nodes, name=""))
        return num_nodes, coords, node_sets
    finally:
        try:
            nc.close()
        except Exception:
            pass


def read_exodus(path: str) -> MeshModel:
    """Read an Exodus-II (netCDF3) mesh file into a :class:`MeshModel`.

    Mirrors the metadata reads of ``IO::assemble`` step 1
    (``ExodusIO.hpp:138-210``) and the full-copy reads of ``IO::decompose``
    (``ExodusIO.hpp:1520-1601``), done once instead of per-call.

    Raises :class:`ExodusReadError` for corrupt/truncated files,
    ``FileNotFoundError`` for missing ones.
    """
    nc = _open_nc(path)
    try:
        dims = nc.dimensions
        num_nodes = int(dims["num_nodes"])
        num_dim = int(dims["num_dim"])

        # --- coordinates (either packed (num_dim, num_nodes) or per-axis) ---
        if "coord" in nc.variables:
            coords = np.array(nc.variables["coord"].data, dtype=np.float64).T
        else:
            axes = []
            for ax in ("coordx", "coordy", "coordz")[:num_dim]:
                arr = _get(nc, ax)
                axes.append(
                    np.zeros(num_nodes) if arr is None else arr.astype(np.float64)
                )
            coords = np.stack(axes, axis=1) if axes else np.zeros((num_nodes, 0))

        coord_names = None
        if "coor_names" in nc.variables:
            cn = np.array(nc.variables["coor_names"].data)
            coord_names = [_chars_to_str(cn[i]) for i in range(cn.shape[0])]

        # --- element blocks ---
        num_el_blk = int(dims.get("num_el_blk", 0) or 0)
        eb_ids = _get(nc, "eb_prop1")
        eb_ids = (
            eb_ids.astype(np.int64)
            if eb_ids is not None
            else np.arange(1, num_el_blk + 1)
        )
        eb_names = None
        if "eb_names" in nc.variables:
            nm = np.array(nc.variables["eb_names"].data)
            eb_names = [_chars_to_str(nm[i]) for i in range(nm.shape[0])]
        blocks: List[ElemBlock] = []
        for i in range(num_el_blk):
            cv = nc.variables[f"connect{i + 1}"]
            conn = np.array(cv.data, dtype=np.int64) - 1  # to 0-based
            elem_type = (
                cv.elem_type.decode("latin-1").strip()
                if isinstance(getattr(cv, "elem_type", ""), bytes)
                else str(getattr(cv, "elem_type", "")).strip()
            )
            attrs = _get(nc, f"attrib{i + 1}")
            blocks.append(
                ElemBlock(
                    id=int(eb_ids[i]),
                    elem_type=elem_type,
                    conn=conn,
                    name=eb_names[i] if eb_names else "",
                    attributes=attrs.astype(np.float64) if attrs is not None else None,
                )
            )

        # --- nodesets ---
        num_ns = int(dims.get("num_node_sets", 0) or 0)
        ns_ids = _get(nc, "ns_prop1")
        ns_ids = (
            ns_ids.astype(np.int64) if ns_ids is not None else np.arange(1, num_ns + 1)
        )
        ns_names = None
        if "ns_names" in nc.variables:
            nm = np.array(nc.variables["ns_names"].data)
            ns_names = [_chars_to_str(nm[i]) for i in range(nm.shape[0])]
        node_sets: List[NodeSet] = []
        for i in range(num_ns):
            nodes = _get(nc, f"node_ns{i + 1}")
            nodes = (
                nodes.astype(np.int64) - 1
                if nodes is not None
                else np.zeros(0, np.int64)
            )
            df = _get(nc, f"dist_fact_ns{i + 1}")
            node_sets.append(
                NodeSet(
                    id=int(ns_ids[i]),
                    nodes=nodes,
                    name=ns_names[i] if ns_names else "",
                    dist_factors=df.astype(np.float64) if df is not None else None,
                )
            )

        # --- sidesets ---
        num_ss = int(dims.get("num_side_sets", 0) or 0)
        ss_ids = _get(nc, "ss_prop1")
        ss_ids = (
            ss_ids.astype(np.int64) if ss_ids is not None else np.arange(1, num_ss + 1)
        )
        ss_names = None
        if "ss_names" in nc.variables:
            nm = np.array(nc.variables["ss_names"].data)
            ss_names = [_chars_to_str(nm[i]) for i in range(nm.shape[0])]
        side_sets: List[SideSet] = []
        for i in range(num_ss):
            elems = _get(nc, f"elem_ss{i + 1}")
            sides = _get(nc, f"side_ss{i + 1}")
            df = _get(nc, f"dist_fact_ss{i + 1}")
            side_sets.append(
                SideSet(
                    id=int(ss_ids[i]),
                    elems=(
                        elems.astype(np.int64) - 1
                        if elems is not None
                        else np.zeros(0, np.int64)
                    ),
                    sides=(
                        sides.astype(np.int64)
                        if sides is not None
                        else np.zeros(0, np.int64)
                    ),
                    name=ss_names[i] if ss_names else "",
                    dist_factors=df.astype(np.float64) if df is not None else None,
                )
            )

        # --- id maps (identity if absent, like ex_get_id_map) ---
        node_id_map = _get(nc, "node_num_map")
        node_id_map = (
            node_id_map.astype(np.int64)
            if node_id_map is not None
            else np.arange(1, num_nodes + 1)
        )
        num_elem = int(dims.get("num_elem", 0) or 0)
        elem_id_map = _get(nc, "elem_num_map")
        elem_id_map = (
            elem_id_map.astype(np.int64)
            if elem_id_map is not None
            else np.arange(1, num_elem + 1)
        )

        # --- QA / info records ---
        qa_records = []
        if "qa_records" in nc.variables:
            qa = np.array(nc.variables["qa_records"].data)
            for i in range(qa.shape[0]):
                qa_records.append(tuple(_chars_to_str(qa[i, j]) for j in range(4)))
        info_records = []
        if "info_records" in nc.variables:
            info = np.array(nc.variables["info_records"].data)
            for i in range(info.shape[0]):
                info_records.append(_chars_to_str(info[i]))

        title = nc.title.decode("latin-1") if isinstance(nc.title, bytes) else str(nc.title)
        mesh = MeshModel(
            coords=coords,
            blocks=blocks,
            node_sets=node_sets,
            side_sets=side_sets,
            title=title,
            num_dim=num_dim,
            node_id_map=node_id_map,
            elem_id_map=elem_id_map,
            coord_names=coord_names,
            qa_records=qa_records,
            info_records=info_records,
        )
        mesh.validate()
        return mesh
    except ExodusReadError:
        raise
    except (KeyError, IndexError, ValueError, TypeError, OSError) as e:
        # Truncated record sections surface as short-buffer/missing-dim
        # errors deep inside scipy/numpy; rewrap with the path.
        raise ExodusReadError(
            f"{path}: corrupt or truncated Exodus file ({type(e).__name__}: {e})"
        ) from e
    finally:
        nc.close()


def read_nodal_vars(path: str):
    """Read back nodal variables: returns (names, times, values[t, var, node]).

    Test/verification helper for the solution files our writer produces (the
    reference's per-timestep snapshots, ``ExodusIO.hpp:2042-2056``).
    """
    nc = _open_nc(path)
    try:
        times = _get(nc, "time_whole", np.zeros(0))
        names = []
        if "name_nod_var" in nc.variables:
            nm = np.array(nc.variables["name_nod_var"].data)
            names = [_chars_to_str(nm[i]) for i in range(nm.shape[0])]
        vals = []
        k = 1
        while f"vals_nod_var{k}" in nc.variables:
            vals.append(np.array(nc.variables[f"vals_nod_var{k}"].data, dtype=np.float64))
            k += 1
        values = np.stack(vals, axis=1) if vals else np.zeros((0, 0, 0))
        return names, np.array(times, dtype=np.float64), values
    finally:
        nc.close()


# ----------------------------------------------------------------------------
# Writing
# ----------------------------------------------------------------------------


def _put_str(var, row: int, s: str):
    """Write a string into row `row` of a (n, len) char variable."""
    width = var.shape[-1]
    data = s.encode("latin-1")[: width - 1]
    buf = np.frombuffer(data + b"\x00" * (width - len(data)), dtype="S1")
    var[row] = buf


class _ExodusFileBuilder:
    """Defines the full Exodus netCDF schema for a MeshModel, then fills it."""

    def __init__(self, path: str, mesh: MeshModel, num_nodal_vars: int = 0,
                 nodal_var_names: Optional[Sequence[str]] = None,
                 title: Optional[str] = None):
        # Empty node/side sets cannot be represented (a zero-size netCDF
        # dimension would read back as a phantom [-1] entry); they carry no
        # information, so drop them from the written file.
        import dataclasses as _dc

        mesh = _dc.replace(
            mesh,
            node_sets=[ns for ns in mesh.node_sets if ns.nodes.size],
            side_sets=[ss for ss in mesh.side_sets if ss.elems.size],
        )
        self.mesh = mesh
        self.num_nodal_vars = num_nodal_vars
        self.nodal_var_names = list(nodal_var_names or [])
        # netCDF3 classic caps any one variable near 2 GB; switch to the
        # 64-bit-offset variant for meshes that could breach it (large
        # connectivity or many-node nodal-variable records).
        approx_bytes = 8 * mesh.num_nodes * max(3, num_nodal_vars) + sum(
            4 * b.conn.size for b in mesh.blocks
        )
        version = 2 if approx_bytes > (1 << 31) - (1 << 27) else 1
        self.nc = netcdf_file(path, "w", version=version)
        self._define(title if title is not None else mesh.title)
        self._fill()

    def _define(self, title: str):
        nc, mesh = self.nc, self.mesh
        nc.title = title.encode("latin-1")
        nc.version = _EX_VERSION
        nc.api_version = _EX_VERSION
        nc.floating_point_word_size = np.int32(8)
        nc.file_size = np.int32(1)

        nc.createDimension("time_step", None)  # unlimited; must be first (scipy)
        nc.createDimension("len_string", 33)
        nc.createDimension("len_line", 81)
        nc.createDimension("len_name", 33)
        nc.createDimension("four", 4)
        nc.createDimension("num_dim", mesh.dim)
        nc.createDimension("num_nodes", mesh.num_nodes)
        if mesh.num_elem:
            nc.createDimension("num_elem", mesh.num_elem)
        if mesh.blocks:
            nc.createDimension("num_el_blk", len(mesh.blocks))
        if mesh.node_sets:
            nc.createDimension("num_node_sets", len(mesh.node_sets))
        if mesh.side_sets:
            nc.createDimension("num_side_sets", len(mesh.side_sets))

        nc.createVariable("time_whole", "d", ("time_step",))

        if mesh.blocks:
            nc.createVariable("eb_status", "i", ("num_el_blk",))
            nc.createVariable("eb_prop1", "i", ("num_el_blk",)).name_ = b"ID"
            nc.createVariable("eb_names", "c", ("num_el_blk", "len_name"))
        for i, b in enumerate(mesh.blocks, start=1):
            nc.createDimension(f"num_el_in_blk{i}", b.num_elem)
            nc.createDimension(f"num_nod_per_el{i}", b.nodes_per_elem)
            v = nc.createVariable(
                f"connect{i}", "i", (f"num_el_in_blk{i}", f"num_nod_per_el{i}")
            )
            v.elem_type = b.elem_type.encode("latin-1")
            if b.attributes is not None and b.attributes.size:
                nc.createDimension(f"num_att_in_blk{i}", b.attributes.shape[1])
                nc.createVariable(
                    f"attrib{i}", "d", (f"num_el_in_blk{i}", f"num_att_in_blk{i}")
                )

        if mesh.node_sets:
            nc.createVariable("ns_status", "i", ("num_node_sets",))
            nc.createVariable("ns_prop1", "i", ("num_node_sets",)).name_ = b"ID"
            nc.createVariable("ns_names", "c", ("num_node_sets", "len_name"))
        for i, ns in enumerate(mesh.node_sets, start=1):
            nc.createDimension(f"num_nod_ns{i}", max(int(ns.nodes.size), 1))
            nc.createVariable(f"node_ns{i}", "i", (f"num_nod_ns{i}",))
            if ns.dist_factors is not None:
                nc.createVariable(f"dist_fact_ns{i}", "d", (f"num_nod_ns{i}",))

        if mesh.side_sets:
            nc.createVariable("ss_status", "i", ("num_side_sets",))
            nc.createVariable("ss_prop1", "i", ("num_side_sets",)).name_ = b"ID"
            nc.createVariable("ss_names", "c", ("num_side_sets", "len_name"))
        for i, ss in enumerate(mesh.side_sets, start=1):
            nc.createDimension(f"num_side_ss{i}", max(int(ss.elems.size), 1))
            nc.createVariable(f"elem_ss{i}", "i", (f"num_side_ss{i}",))
            nc.createVariable(f"side_ss{i}", "i", (f"num_side_ss{i}",))
            if ss.dist_factors is not None and ss.dist_factors.size:
                nc.createDimension(f"num_df_ss{i}", int(ss.dist_factors.size))
                nc.createVariable(f"dist_fact_ss{i}", "d", (f"num_df_ss{i}",))

        for ax in ("coordx", "coordy", "coordz")[: mesh.dim]:
            nc.createVariable(ax, "d", ("num_nodes",))
        nc.createVariable("coor_names", "c", ("num_dim", "len_name"))

        if mesh.num_elem:
            nc.createVariable("elem_map", "i", ("num_elem",))
            nc.createVariable("elem_num_map", "i", ("num_elem",))
        nc.createVariable("node_num_map", "i", ("num_nodes",))

        if mesh.qa_records:
            nc.createDimension("num_qa_rec", len(mesh.qa_records))
            nc.createVariable("qa_records", "c", ("num_qa_rec", "four", "len_string"))
        if mesh.info_records:
            nc.createDimension("num_info", len(mesh.info_records))
            nc.createVariable("info_records", "c", ("num_info", "len_line"))

        if self.num_nodal_vars:
            nc.createDimension("num_nod_var", self.num_nodal_vars)
            nc.createVariable("name_nod_var", "c", ("num_nod_var", "len_name"))
            for k in range(1, self.num_nodal_vars + 1):
                nc.createVariable(
                    f"vals_nod_var{k}", "d", ("time_step", "num_nodes")
                )

    def _fill(self):
        nc, mesh = self.nc, self.mesh
        dim = mesh.dim
        for j, ax in enumerate(("coordx", "coordy", "coordz")[:dim]):
            col = (
                mesh.coords[:, j]
                if j < mesh.coords.shape[1]
                else np.zeros(mesh.num_nodes)
            )
            nc.variables[ax][:] = col.astype(np.float64)
        default_names = ("x", "y", "z")[:dim]
        names = list(mesh.coord_names or default_names)
        for j in range(dim):
            _put_str(nc.variables["coor_names"], j, names[j] if j < len(names) else "")

        if mesh.blocks:
            nc.variables["eb_status"][:] = np.ones(len(mesh.blocks), np.int32)
            nc.variables["eb_prop1"][:] = np.array(
                [b.id for b in mesh.blocks], np.int32
            )
            for i, b in enumerate(mesh.blocks):
                _put_str(nc.variables["eb_names"], i, b.name)
                nc.variables[f"connect{i + 1}"][:] = (b.conn + 1).astype(np.int32)
                if b.attributes is not None and b.attributes.size:
                    nc.variables[f"attrib{i + 1}"][:] = b.attributes

        if mesh.node_sets:
            nc.variables["ns_status"][:] = np.ones(len(mesh.node_sets), np.int32)
            nc.variables["ns_prop1"][:] = np.array(
                [s.id for s in mesh.node_sets], np.int32
            )
            for i, ns in enumerate(mesh.node_sets):
                _put_str(nc.variables["ns_names"], i, ns.name)
                if ns.nodes.size:
                    nc.variables[f"node_ns{i + 1}"][:] = (ns.nodes + 1).astype(np.int32)
                if ns.dist_factors is not None and ns.nodes.size:
                    nc.variables[f"dist_fact_ns{i + 1}"][:] = ns.dist_factors

        if mesh.side_sets:
            nc.variables["ss_status"][:] = np.ones(len(mesh.side_sets), np.int32)
            nc.variables["ss_prop1"][:] = np.array(
                [s.id for s in mesh.side_sets], np.int32
            )
            for i, ss in enumerate(mesh.side_sets):
                _put_str(nc.variables["ss_names"], i, ss.name)
                if ss.elems.size:
                    nc.variables[f"elem_ss{i + 1}"][:] = (ss.elems + 1).astype(np.int32)
                    nc.variables[f"side_ss{i + 1}"][:] = ss.sides.astype(np.int32)
                if ss.dist_factors is not None and ss.dist_factors.size:
                    nc.variables[f"dist_fact_ss{i + 1}"][:] = ss.dist_factors

        if mesh.num_elem:
            emap = (
                mesh.elem_id_map
                if mesh.elem_id_map is not None
                else np.arange(1, mesh.num_elem + 1)
            )
            nc.variables["elem_map"][:] = np.arange(1, mesh.num_elem + 1, dtype=np.int32)
            nc.variables["elem_num_map"][:] = emap.astype(np.int32)
        nmap = (
            mesh.node_id_map
            if mesh.node_id_map is not None
            else np.arange(1, mesh.num_nodes + 1)
        )
        nc.variables["node_num_map"][:] = nmap.astype(np.int32)

        for i, rec in enumerate(mesh.qa_records):
            for j in range(4):
                _put_str(nc.variables["qa_records"][i], j, rec[j] if j < len(rec) else "")
        for i, line in enumerate(mesh.info_records):
            _put_str(nc.variables["info_records"], i, line)

        for k, nm in enumerate(self.nodal_var_names[: self.num_nodal_vars]):
            _put_str(nc.variables["name_nod_var"], k, nm)


def write_exodus(path: str, mesh: MeshModel, title: Optional[str] = None) -> None:
    """Write a MeshModel as an Exodus-II (netCDF3 classic) file."""
    builder = _ExodusFileBuilder(path, mesh, title=title)
    builder.nc.close()


class ExodusSolutionWriter:
    """Streams per-iteration solution snapshots to an output Exodus file.

    TPU-framework analogue of ``IO::create`` + ``IO::writeSolution``
    (``ExodusIO.hpp:103-114, :1972-2070``): declares one nodal variable
    (default name matches the reference's ``"Steady-State Heat Solution"``,
    ``ExodusIO.hpp:2032``), writes timestep 0 as the boundary snapshot (each
    boundary node = its nodeset id, free nodes = 0, ``ExodusIO.hpp:1979-1989``),
    then appends one timestep per solver iteration with free-node values
    scattered through the free→mesh index map (``ExodusIO.hpp:2045-2056``).
    """

    def __init__(self, path: str, mesh: MeshModel,
                 var_name: str = "Steady-State Heat Solution",
                 title: Optional[str] = None,
                 boundary_values: Optional["np.ndarray"] = None):
        self.mesh = mesh
        self.var_name = var_name
        self._builder = _ExodusFileBuilder(
            path, mesh, num_nodal_vars=1, nodal_var_names=[var_name], title=title
        )
        self.nc = self._builder.nc
        self._step = 0
        self._printed_time_zero = False
        # boundary_values overrides the timestep-0 snapshot (per-node array;
        # default = the reference's nodeset-id convention).
        self._node_vals = (
            np.asarray(boundary_values, dtype=np.float64).copy()
            if boundary_values is not None
            else mesh.boundary_write_values()
        )

    def write_boundary_timestep(self) -> None:
        """Timestep index 0 at t=0: the boundary-condition snapshot."""
        if self._printed_time_zero:
            return
        self.nc.variables["time_whole"][self._step] = 0.0
        self.nc.variables["vals_nod_var1"][self._step] = self._node_vals
        self._step += 1
        self._printed_time_zero = True

    def write_solution(self, free_values: np.ndarray, free_to_node: np.ndarray,
                       timestep: int) -> None:
        """Append a solution snapshot.

        ``free_values[k]`` is the solution at free node ``free_to_node[k]``
        (0-based mesh node index) — the analogue of the reference's
        ``globalIDMap``-routed scatter (``ExodusIO.hpp:2045-2056``).
        """
        self.write_boundary_timestep()
        self._node_vals[np.asarray(free_to_node, dtype=np.int64)] = np.asarray(
            free_values, dtype=np.float64
        )
        self.nc.variables["time_whole"][self._step] = float(timestep)
        self.nc.variables["vals_nod_var1"][self._step] = self._node_vals
        self._step += 1

    def close(self) -> None:
        self.nc.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
