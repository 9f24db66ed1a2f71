"""COLMAP sqlite database writer (standard public COLMAP schema; port of
`gim_tpu/hloc/database.py`, copied: host `sqlite3` and numpy, the same
schema, ids and blob layouts byte for byte).

Fills the role of ref hloc/utils/database.py:141-233 + hloc/triangulation.py
import steps: create an empty database, import cameras/images/keypoints/
matches so COLMAP (or pycolmap) can run geometric verification and
incremental mapping.
"""

from __future__ import annotations

import sqlite3

import numpy as np

MAX_IMAGE_ID = 2 ** 31 - 1

SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""


def pair_id_of(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def _blob(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr).tobytes()


class ColmapDB:
    def __init__(self, path: str):
        self.con = sqlite3.connect(path)
        self.con.executescript(SCHEMA)

    def add_camera(self, model: int, width: int, height: int,
                   params: np.ndarray, prior_focal: bool = False,
                   camera_id: int | None = None) -> int:
        cur = self.con.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, model, width, height,
             _blob(np.asarray(params, np.float64)), int(prior_focal)))
        return cur.lastrowid

    def add_image(self, name: str, camera_id: int,
                  image_id: int | None = None) -> int:
        cur = self.con.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, None, None, None, None, None, None,
             None))
        return cur.lastrowid

    def add_keypoints(self, image_id: int, kpts: np.ndarray):
        kpts = np.asarray(kpts, np.float32)
        if kpts.shape[1] == 2:  # COLMAP wants x, y, scale, orientation
            kpts = np.concatenate(
                [kpts, np.ones_like(kpts[:, :1]),
                 np.zeros_like(kpts[:, :1])], axis=1)
        self.con.execute("INSERT INTO keypoints VALUES (?, ?, ?, ?)",
                         (image_id, kpts.shape[0], kpts.shape[1],
                          _blob(kpts)))

    def add_matches(self, image_id1: int, image_id2: int,
                    matches: np.ndarray):
        matches = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        self.con.execute("INSERT INTO matches VALUES (?, ?, ?, ?)",
                         (pair_id_of(image_id1, image_id2),
                          matches.shape[0], 2, _blob(matches)))

    def add_two_view_geometry(self, image_id1: int, image_id2: int,
                              matches: np.ndarray, F=None, E=None, H=None,
                              config: int = 2):
        matches = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        eye = np.eye(3, dtype=np.float64)
        self.con.execute(
            "INSERT INTO two_view_geometries VALUES (?, ?, ?, ?, ?, ?, ?, ?,"
            " ?, ?)",
            (pair_id_of(image_id1, image_id2), matches.shape[0], 2,
             _blob(matches), config,
             _blob(np.asarray(F if F is not None else eye, np.float64)),
             _blob(np.asarray(E if E is not None else eye, np.float64)),
             _blob(np.asarray(H if H is not None else eye, np.float64)),
             _blob(np.array([1, 0, 0, 0], np.float64)),
             _blob(np.zeros(3, np.float64))))

    def commit(self):
        self.con.commit()

    def close(self):
        self.con.commit()
        self.con.close()
