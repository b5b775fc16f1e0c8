"""The large-F path's precomputed bins and their rebin policy: one
:class:`EpochBins` an epoch that :func:`takes_bins`."""
from __future__ import annotations

import time
import warnings
from collections import deque

import numpy as np
import torch

from .. import spans as _spans
from ..parallel import distributed as pdist
from ..render.camera import project
from ..render.pipeline import (DEVICE_BIN_SPAN, bin_triangles_device,
                               bin_triangles_host, suggest_cap)
from ..spans import span as _span

__all__ = ["EpochBins", "takes_bins", "host_bins", "rebin_record"]

# the face→slot width: the device binning's, so rebins keep the pipe's shapes
K = DEVICE_BIN_SPAN[0] * DEVICE_BIN_SPAN[1]


def _queued(t):
    """(a pinned host copy of the device scalar ``t``, readable once the
    event behind it completes, that event), queued without waiting (``(t,
    None)`` on the CPU): ``float()`` would wait for every queued step."""
    if t.device.type != "cuda":
        return t, None
    h = torch.empty((), dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    e = torch.cuda.Event()
    e.record()
    return h, e


def _wait(event, site):
    """Wait for ``event`` (None: done already), a host wait at ``site``."""
    with _span("host_wait", site):
        if event is not None:
            event.synchronize()


def takes_bins(renderer, topology, p) -> bool:
    """Whether ``topology`` renders on precomputed bins: the tiles renderer
    and ``host_bin_faces`` faces or more."""
    return renderer.backend == "tiles" and \
        topology.n_faces >= int(p["host_bin_faces"])


def rebin_record():
    """``prof``'s rebin counters, empty (:meth:`EpochBins.before`)."""
    return {"rebin_s": 0.0, "rebin_n": 0, "rebin_steps": [], "rebin_routes":
            dict.fromkeys(("device", "host_spans", "host_overflow"), 0)}


def _pixels(renderer, v_ndc):
    """(C, V, 2) pixel positions from NDC (C, V, 4), numpy or torch."""
    h, w = renderer.res
    mod = torch if isinstance(v_ndc, torch.Tensor) else np
    ww = v_ndc[..., 3]
    safe_w = mod.where(ww == 0, 1.0, ww)
    return mod.stack([(v_ndc[..., 0] / safe_w + 1.0) * (w / 2.0),
                      (v_ndc[..., 1] / safe_w + 1.0) * (h / 2.0)], -1)


def _device_pixels(renderer, v):
    """(C, V, 2) device pixel positions of (V, 3) host or device vertices."""
    with torch.no_grad():
        return _pixels(renderer, project(torch.as_tensor(
            v, dtype=torch.float32, device=renderer.device), renderer.mvps))


def host_bins(renderer, v, topology, margin, cap=None, cull=False, k=K):
    """Bins of the (V, 3) host vertices ``v`` made on the host at ``cap``,
    or where they overflow it (or ``cap`` is None) at the cap that fits
    their occupancy.  The face→slot inverse is padded with its sentinel
    T·cap to width ``k`` where the bins keep ``cap`` (a narrower one would
    only rebuild the pipe), else to ``K``.  Returns ((bins int64, counts
    int32, fslots int64) on the device, occupancy, cap, host (C, V, 2)
    pixel positions, the most tiles a face spans (y, x)), on a mesh the
    occupancy, cap and spans every rank's."""
    v_host = np.asarray(v, np.float32)
    mvps = renderer.mvps.cpu().numpy()
    vh = np.concatenate([v_host, np.ones((v_host.shape[0], 1), np.float32)],
                        axis=1)
    v_ndc = np.einsum("cij,vj->cvi", mvps, vh)
    run = lambda c: bin_triangles_host(v_ndc, topology.faces, renderer.res,
                                       cap=c, margin=margin, cull=cull,
                                       return_spans=True, return_slots=True)
    bins, counts, fslots, occ, spans = run(cap)
    occ, sy, sx = pdist.host_max([occ, *spans], renderer.mesh)
    fit = suggest_cap(int(occ)) if cap is None or occ > cap else cap
    if fit != bins.shape[-1]:
        bins, counts, fslots = run(fit)[:3]
    k = k if fit == cap else K
    if fslots.shape[-1] < k:
        fslots = np.pad(fslots, ((0, 0), (0, 0), (0, k - fslots.shape[-1])),
                        constant_values=bins.shape[1] * bins.shape[-1])
    up = lambda a, dt: torch.as_tensor(a, device=renderer.device).to(dt)
    return ((up(bins, torch.int64), up(counts, torch.int32),
             up(fslots, torch.int64)), int(occ), bins.shape[-1],
            _pixels(renderer, v_ndc), (int(sy), int(sx)))


class EpochBins:
    """The bins of one large-F epoch, and what their rebin policy keeps
    between steps.  Made on the host from the epoch's source vertices with
    a ``rebin_margin`` px bbox expansion at ``host_bin_cap`` (or the cap
    that fits).  Before each step but the epoch's first, :meth:`before`
    rebins where :meth:`due`: on the device, or on the host where the tile
    spans pass ``DEVICE_BIN_SPAN`` or the last device rebin
    :meth:`overflowed`; on a mesh, where any rank's events say so.
    :meth:`after` queues the step's :meth:`displacement`, keeping at most
    ``max_inflight`` steps queued."""

    def __init__(self, renderer, p, v_src, topology, duplicate_idx):
        self.renderer, self.p, self.topology = renderer, p, topology
        # (bins, counts, fslots) on the device
        self.tensors, self.occupancy, self.cap, self.last_sxy, spans = \
            host_bins(renderer, v_src, topology, p["rebin_margin"],
                      cap=p["host_bin_cap"], cull=p["cull_backfaces"])
        self.max_window_disp = 0.0  # the largest displacement read (px)
        self.device_ok = (spans[0] <= DEVICE_BIN_SPAN[0]
                          and spans[1] <= DEVICE_BIN_SPAN[1])
        self.dup_dev = torch.as_tensor(duplicate_idx.astype(np.int64),
                                       device=renderer.device)
        self.faces_dev = torch.as_tensor(topology.faces.astype(np.int64),
                                         device=renderer.device)
        self.sxy_dev = _device_pixels(renderer, v_src)  # at bin time
        self.pending_occ = None     # (occupancy, event): last device rebin
        self.disp_q = deque()       # (host displacement, event) a step
        self.inflight = deque()     # (step, event) of the queued steps
        self.last_it = None         # its first step, then its last rebin's

    def _translation(self, tr):
        return tr.detach() if self.p["use_tr"] else torch.zeros_like(tr)

    def _host_vertices(self, v_unique, tr):
        """The rendered (V, 3) vertices on the host, of the translation
        parameter ``tr``."""
        tr = self._translation(tr)
        return (v_unique.cpu()[self.dup_dev.cpu()] + tr.cpu()).numpy()

    def displacement(self, v_render):
        """The largest screen displacement (px) of the rendered vertices
        since the bins were made, a device scalar."""
        with _span("displacement"):
            sxy = _device_pixels(self.renderer, v_render.detach())
            return (sxy - self.sxy_dev).abs().max()

    def due(self, since) -> bool:
        """Whether to rebin now: ``rebin_every`` steps since the last rebin,
        or (``rebin_auto``) a step moved a vertex more than margin/2 px
        since the bins were made.  Reads the host copies of the
        displacements of every queued step but the last, oldest first,
        waiting for each: a fixed lag of one step, so that the decision does
        not depend on how far the card has got (reading whichever had run
        made the rebin steps, and so the fit, vary from run to run), and
        one that seldom waits (before step i, for steps up to i − 2)."""
        p = self.p
        due = bool(p["rebin_every"]) and since >= int(p["rebin_every"])
        if not p["rebin_auto"]:
            return due
        while len(self.disp_q) > 1:
            disp, event = self.disp_q.popleft()
            _wait(event, "rebin_due")
            d = float(disp)
            self.max_window_disp = max(self.max_window_disp, d)
            due = due or d > 0.5 * float(p["rebin_margin"])
        return due

    def overflowed(self) -> bool:
        """Whether the last device rebin's bins overflowed their cap
        (waiting for its occupancy, queued before the steps since, so that
        the answer does not depend on the host's timing).  An overflow
        sends this rebin to the host, which grows the cap."""
        if self.pending_occ is None:
            return False
        _wait(self.pending_occ[1], "overflow")
        occ = int(self.pending_occ[0])
        self.pending_occ = None
        if occ > self.cap:
            warnings.warn(f"bin occupancy {occ} exceeded cap {self.cap} "
                          f"during the last window; growing")
        return occ > self.cap

    def rebin_device(self, v_render):
        """Rebin on the device from the (V, 3) device vertices; the
        occupancy stays on the device until the next rebin reads it."""
        p, renderer = self.p, self.renderer
        with torch.no_grad():
            v_ndc = project(v_render, renderer.mvps)
            bins, counts, fslots, occ = bin_triangles_device(
                v_ndc, self.faces_dev, renderer.res, self.cap,
                margin=float(p["rebin_margin"]),
                cull=bool(p["cull_backfaces"]))
            self.tensors = (bins, counts, fslots)
            self.sxy_dev = _pixels(renderer, v_ndc)
        self.pending_occ = _queued(occ)

    def rebin_host(self, v):
        """Rebin on the host from the (V, 3) host vertices: grows the cap
        where the bins overflow it, and warns where a vertex moved more
        than margin/2 px since the last host rebin (that window's tiles may
        have under-drawn)."""
        p, margin = self.p, self.p["rebin_margin"]
        tensors, _, self.cap, sxy, _ = host_bins(
            self.renderer, v, self.topology, margin, cap=self.cap,
            cull=p["cull_backfaces"], k=self.tensors[2].shape[-1])
        if self.last_sxy.shape == sxy.shape:
            disp = float(np.max(np.abs(sxy - self.last_sxy)))
            self.max_window_disp = max(self.max_window_disp, disp)
            if disp > 0.5 * float(margin):
                warnings.warn(
                    f"vertices moved up to {disp:.2f} px between host rebins "
                    f"(> margin/2 = {0.5 * float(margin):.2f}); the last "
                    f"{p['rebin_every']}-step window may have under-drawn "
                    f"tiles - lower rebin_every or raise rebin_margin")
        self.last_sxy = sxy         # at the last host rebin
        self.tensors = tensors
        self.sxy_dev = _device_pixels(self.renderer, v)

    def resume(self, v_unique, tr):
        """Rebin on the host from a resumed run's restored (V′, 3) solved
        vertices, which may be far from the bins' source vertices."""
        self.rebin_host(self._host_vertices(v_unique, tr))

    def before(self, it, v_last, tr, record):
        """Rebin before step ``it`` where it is due, from the last step's
        (V′, 3) solved vertices and the translation parameter ``tr``, and
        count it into ``record`` by route: ``device``, ``host_spans``,
        ``host_overflow``."""
        mesh = self.renderer.mesh
        if self.last_it is None:    # the epoch's first step
            self.last_it = it
            return
        due = self.due(it - self.last_it)
        if mesh is not None:
            due = pdist.host_max([due], mesh)[0] > 0
        if not due:
            return
        t0 = time.perf_counter()
        with _span("rebin"):
            on_device = self.device_ok and not self.overflowed()
            if mesh is not None:
                on_device = pdist.host_max([not on_device], mesh)[0] == 0
            if on_device:
                self.rebin_device(v_last[self.dup_dev]
                                  + self._translation(tr))
            else:
                with _span("host_wait", "host_rebin"):
                    v_host = self._host_vertices(v_last, tr)
                _spans.waited()
                self.rebin_host(v_host)
                self.pending_occ = None
        route = "device" if on_device else \
            "host_overflow" if self.device_ok else "host_spans"
        record["rebin_routes"][route] += 1
        self.last_it = it
        self.disp_q.clear()
        record["rebin_s"] += time.perf_counter() - t0
        record["rebin_n"] += 1
        record["rebin_steps"].append(it)

    def after(self, it, disp):
        """Queue step ``it``'s displacement ``disp`` (a device scalar)."""
        disp, event = _queued(disp)
        self.disp_q.append((disp, event))
        self.inflight.append((it, event))
        if len(self.inflight) > int(self.p["max_inflight"]):
            done, event = self.inflight.popleft()
            _wait(event, "inflight")
            _spans.waited(done)
