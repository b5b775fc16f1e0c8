"""Scene construction and file I/O (host numpy): PLY meshes, Radiance HDR
images, Mitsuba-style scene XML and synthetic scenes."""
from .ply import read_ply, write_ply
from .hdr import read_hdr, write_hdr
from .xml_scene import load_scene
from .synth import make_scene, save_scene, make_envmap, turntable_views
