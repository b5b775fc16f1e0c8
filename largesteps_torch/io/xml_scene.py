"""Mitsuba-2-style XML scene loading.

A copy of ``largesteps_tpu/io/xml_scene.py`` on the port's camera, PLY and
HDR modules.

Reference semantics: scripts/load_xml.py:45-126 — ``<default resx/resy>``,
``<sensor>`` (fov/near_clip/far_clip, transform composed of rotate/translate,
stored as the **inverted** view matrix), ``<emitter type="envmap">`` (HDR +
alpha channel, scale), ``<shape type="ply">`` keyed by id (must include
``mesh-source`` and ``mesh-target``), with the same completeness assertions.
Host-side numpy throughout.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from .ply import read_ply
from .hdr import read_hdr
from ..render.camera import rotation_matrix, translation_matrix

__all__ = ["load_scene"]


def load_scene(filepath):
    """Load meshes, envmap and cameras from a scene XML file → params dict
    (same keys as the reference: res_x, res_y, fov, near_clip, far_clip,
    view_mats, envmap, envmap_scale, mesh-source, mesh-target)."""
    folder, filename = os.path.split(filepath)
    _, ext = os.path.splitext(filename)
    assert ext == ".xml", f"Unexpected file type: '{ext}'"

    root = ET.parse(filepath).getroot()
    assert root.tag == "scene", f"scene XML must have a <scene> root, got <{root.tag}>"

    params = {"view_mats": [], "envmap_scale": 1.0}

    for plugin in root:
        if plugin.tag == "default":
            if plugin.attrib["name"] == "resx":
                params["res_x"] = int(plugin.attrib["value"])
            elif plugin.attrib["name"] == "resy":
                params["res_y"] = int(plugin.attrib["value"])
        elif plugin.tag == "sensor":
            view_mat = np.eye(4, dtype=np.float64)
            for prop in plugin:
                if prop.tag == "float":
                    name = prop.attrib["name"]
                    if name in ("fov", "near_clip", "far_clip") and name not in params:
                        params[name] = float(prop.attrib["value"])
                elif prop.tag == "transform":
                    for tr in prop:
                        if tr.tag == "rotate":
                            axis = "x" if "x" in tr.attrib else ("y" if "y" in tr.attrib else "z")
                            view_mat = rotation_matrix(axis, float(tr.attrib["angle"])) @ view_mat
                        elif tr.tag == "translate":
                            vec = np.fromstring(tr.attrib["value"], dtype=float, sep=" ")
                            view_mat = translation_matrix(vec) @ view_mat
                        else:
                            raise NotImplementedError(
                                f"sensor transform element <{tr.tag}> not "
                                "handled (only <rotate>/<translate> are)"
                            )
            params["view_mats"].append(np.linalg.inv(view_mat).astype(np.float32))
        elif plugin.tag == "emitter" and plugin.attrib.get("type") == "envmap":
            for prop in plugin:
                if prop.tag == "string" and prop.attrib["name"] == "filename":
                    envmap = read_hdr(os.path.join(folder, prop.attrib["value"]))
                    alpha = np.ones((*envmap.shape[:2], 1), np.float32)
                    params["envmap"] = np.concatenate([envmap, alpha], axis=-1)
                elif prop.tag == "float" and prop.attrib["name"] == "scale":
                    params["envmap_scale"] = float(prop.attrib["value"])
        elif plugin.tag == "shape":
            if plugin.attrib["type"] == "ply":
                for prop in plugin:
                    if prop.tag == "string" and prop.attrib["name"] == "filename":
                        assert "id" in plugin.attrib, "ply <shape> needs an id attribute"
                        params[plugin.attrib["id"]] = read_ply(
                            os.path.join(folder, prop.attrib["value"])
                        )
            else:
                raise NotImplementedError(
                    f"shape plugin '{plugin.attrib['type']}' not handled — "
                    "meshes must be PLY"
                )

    assert "mesh-source" in params, "scene lacks a mesh-source shape"
    assert "mesh-target" in params, "scene lacks a mesh-target shape"
    assert "envmap" in params, "scene lacks an envmap emitter"
    assert len(params["view_mats"]) > 0, "scene defines no sensors (cameras)"
    return params
