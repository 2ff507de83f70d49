"""The data of both cells, frozen: the sha256 of every array
``two_patterns.cell_data`` returns at each cell's own pool size, and the
first 8 raw draws of the arrivals' and the comparison sample's streams,
at a positive seed, a negative one and one past 64 bits. A change of the
harness that moves a cell's inputs or its sample fails here."""
from __future__ import annotations

import hashlib

import numpy as np
import pytest

from perfbench.bench import cells
from perfbench.tests.helpers import ROOT
from perfbench.traffic import two_patterns

SEEDS = (12345, -(2 ** 31) - 17, 2 ** 64 + 987654321)

# one fixed draw of the train split (train_seed 0), the same at every seed
TRAIN = {
    "X_train": ("float32", (1000, 128), "366520ae2b49e4152aed6d16e3605bdd"
                "9972bf77f7a18610d57a100d10db3d5a"),
    "y_train": ("int32", (1000,), "bef11d39fa6d4f91c11dded8cfe730cb"
                "4c4fd2f264d204bbd7e92e06bec4e39e"),
}
POOL = {
    12345: ("3a793cec8cc5790e1b848a20f13c67d78b2cb76191c553d407411fef0868bbf1",
            "e2250ee6a88019291b9aac9eadab9e929239e37d345276315cf1753e53040f30"),
    -(2 ** 31) - 17: (
        "02a077624905e2fb2bd3773a0b9c41363ee2c3429fe1a6cc46b1fc791c4cdc66",
        "6d2546401a819b7a2d81e401e5369ecfdb0f371d828a98667a815d0f0903ff68"),
    2 ** 64 + 987654321: (
        "0bf8c578d50958755b5b4a69e051796337764bebaaf618e12a4af9a4501a45ca",
        "4150839b7bea694446e69009fa0638180b6008e2e8f6eaf17efd329a7c5f6023"),
}
# the first 8 raw 64-bit draws of the ARRIVALS and SAMPLE streams
DRAWS = {
    12345: (
        [4325269678306458542, 265064398644531820, 8447728894755613077,
         107545687374212010, 14392100078600422612, 17157054117212039897,
         5381199140249781205, 17751606958167320006],
        [14836371521697013897, 13874807005802917134, 13335168863658432661,
         16657385369602253980, 13450663351452472033, 15216839610626734174,
         7641574808775699353, 13646570215453869848]),
    -(2 ** 31) - 17: (
        [16067520520160005021, 15460498158951244350, 18299928616801155753,
         1522638646951621994, 6971703163264904936, 6777151412420695879,
         15685421547277844908, 18093482662901742668],
        [1020723759885347178, 13933145913233987789, 4750696088677478728,
         14027347561333451935, 15981429810680392739, 1004597811681673961,
         14319725932626114381, 3528948903602959870]),
    2 ** 64 + 987654321: (
        [17899817351961729649, 2269690371390590705, 11004020685902858887,
         18070206886869100888, 11520876711243547008, 5154541947608252940,
         16291164535064335166, 7078897542738100659],
        [17331939768190219250, 13261611217186443716, 2706773030796213827,
         14761904589318904394, 10018714293771764069, 9752034638366455748,
         11601248857525627436, 16648577933813848417]),
}


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["spdtw-1nn-bulk", "spkrdtw-svm-bulk"])
def test_cell_data_is_frozen(cell, seed):
    c = cells.Cell(ROOT, cell)
    data = two_patterns.cell_data(c.cfg, int(c.wl["pool_series"]), seed)
    P = int(c.wl["pool_series"])
    want = {**TRAIN,
            "pool": ("float32", (P, 128), POOL[seed][0]),
            "y_pool": ("int32", (P,), POOL[seed][1])}
    assert set(data) == set(want)
    for key, (dtype, shape, digest) in want.items():
        a = data[key]
        assert (str(a.dtype), a.shape, _sha(a)) == (dtype, shape, digest), \
            key


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_draws_are_frozen(seed):
    got = tuple([int(x) for x in two_patterns.seed_rng(
        seed, stream).bit_generator.random_raw(8)]
        for stream in (two_patterns.ARRIVALS, two_patterns.SAMPLE))
    assert got == DRAWS[seed]
