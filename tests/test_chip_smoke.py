"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its phase
functions run end to end at tiny sizes (the full sizes run on the card)."""

import json
import pathlib
import sys

import jax
import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def test_main_refuses_cpu_backend(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main([]) != 0
    out, err = capsys.readouterr()
    assert "needs a GPU" in err
    assert '"ok"' not in out
    assert chip_smoke.main(["--four-cards"]) != 0


def test_phase_env_tiny():
    rows = chip_smoke.phase_env(
        workloads=("flagship_single_room_4096", "multi_player_2p_4096"),
        num_envs=16, steps=32, reps=3, num_rays=16, height_px=16,
        map_h=4, map_w=5,
    )
    assert [r["name"] for r in rows] == [
        "flagship_single_room_4096", "multi_player_2p_4096"
    ]
    for r in rows:
        assert r["env_steps_per_s"] > 0 and len(r["times_s"]) == 3
        json.dumps(r)


def test_phase_parity_subset():
    counts = chip_smoke.phase_parity(
        trajectories=["single_room[1]", "exhaustive_headings"],
        golden=["maze"],
    )
    assert set(counts) == {
        "single_room[1]", "exhaustive_headings", "golden[maze]"
    }
    assert all(v == 0 for c in counts.values() for v in c.values())


def test_parity_bound_admits_only_named_ulp_differences():
    from raycastworlds_tpu.oracle import parity

    res = parity.Parity()
    one_ulp = np.nextafter(np.float32(3.0), np.float32(4.0))
    res.check("dist", np.float32([1.0, one_ulp]), np.float32([1.0, 3.0]))
    assert res.mismatches == {"dist": 1} and res.max_ulp == {"dist": 1}
    assert res.within({"dist": 2}) and not res.within({})
    res.check("dist", np.float32([8.0]), np.float32([np.nextafter(
        np.nextafter(np.nextafter(np.float32(8.0), np.float32(9)),
                     np.float32(9)), np.float32(9))]))
    assert res.max_ulp == {"dist": 3} and not res.within({"dist": 2})
    res2 = parity.Parity()
    res2.check("frame", np.uint32([1, 2]), np.uint32([1, 3]))
    assert not res2.within({"dist": 2})
    np.testing.assert_array_equal(
        parity.ulp_distance(np.float32([-0.0, 1.0]), np.float32([0.0, 1.0])),
        [0, 0],
    )


def test_phase_learner_tiny():
    rows = chip_smoke.phase_learner(
        num_envs=8, rollout_steps=4, hidden=16, size=16
    )
    assert {r["name"] for r in rows} == set(chip_smoke.LEARNER_WORKLOADS)
    for r in rows:
        assert r["param_leaves_moved"] > 0


def test_phase_four_cards_on_virtual_devices():
    """dp=4 rollouts bit-equal to one device; PPO on dp=4 and dp=2 x mp=2
    within the stated tolerance (conftest's 8 virtual CPU devices)."""
    out = chip_smoke.phase_four_cards(
        dp=4,
        env_kw=dict(per_card_envs=4, steps=8, num_rays=16, height_px=16),
        ppo_kw=dict(num_envs=16, rollout_steps=4, size=16, hidden=32),
    )
    assert [r["mismatching_elements"] for r in out["rollouts"]] == [0, 0]
    assert [(r["dp"], r["mp"]) for r in out["ppo"]] == [(4, 1), (2, 2)]
    assert len(out["peak_bytes_in_use"]) == 4
