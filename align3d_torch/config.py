"""Where the test fixtures live (port of ``align3d_tpu/config.py``).

``ALIGN3D_REF_DATA`` overrides the path of the fixture tree (SlamTb
sample1/2, bloei.jpg, teapot.off/ply); it defaults to the copy vendored in
the repository under ``tests/data``. Only tests and measurement tools read
it.
"""

import os

_IN_REPO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "data")
REF_DATA_DIR = os.environ.get("ALIGN3D_REF_DATA", _IN_REPO)


def ref_data_path(*parts: str) -> str:
    return os.path.join(REF_DATA_DIR, *parts)


def has_ref_data() -> bool:
    return os.path.isdir(REF_DATA_DIR)
