"""The traffic generator: nave_walk's loop and the seed's part in it."""

import math

import pytest

from vkbench import manifest, walk

MIX = manifest.traffic("nave_walk")


def test_nave_walk_is_the_loop_the_mix_describes():
    poses = MIX["poses"]
    assert len(poses) == 64
    assert poses[0] == [9.0, 1.8, 0.3, round(math.pi / 2, 6), 0.0]
    xs = [p[0] for p in poses]
    # 32 steps forward (-x), 32 back: one 0.0833 step between poses, the
    # loop closed
    assert min(xs) == pytest.approx(9.0 - 32 * 0.0833, abs=1e-3)
    assert max(xs) == 9.0
    assert xs[32] == min(xs)
    for i in range(64):
        assert abs(xs[i] - xs[i - 1]) == pytest.approx(0.0833, abs=2e-4)
    assert all(p[1:3] == [1.8, 0.3] for p in poses)
    yaws = [p[3] for p in poses]
    assert max(abs(y - math.pi / 2) for y in yaws) == pytest.approx(0.1,
                                                                   abs=1e-3)
    assert len({tuple(p) for p in poses}) == 64   # every view differs


@pytest.mark.parametrize("seed", [0, 1, 63, 64, 2**31 + 5, 2**33 + 17])
def test_every_seed_walks_the_same_poses_rotated(seed):
    loop = MIX["poses"]
    run = [walk.pose(MIX, seed, i) for i in range(64)]
    start = walk.start(MIX, seed)
    assert run == loop[start:] + loop[:start]
    assert walk.pose(MIX, seed, 64 + 5) == run[5]


def test_warmup_and_sample_come_from_the_seed():
    assert walk.warmup(MIX, 7) == walk.warmup(MIX, 7)
    assert len(walk.warmup(MIX, 7)) == MIX["warmup_poses"]
    a = walk.sample(2**31 + 11, 64, 3)
    assert a == walk.sample(2**31 + 11, 64, 3)
    assert len(set(a)) == 3 and all(0 <= i < 64 for i in a)
    assert walk.sample(5, 2, 3) == [0, 1]
