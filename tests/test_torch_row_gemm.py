"""The schedule of K1's, K2's and K4's persistent bf16 walk
(`cvmm.row_gemm_schedule` and `cvmm.row_gemm_block_items`, the Python
mirror of csrc/row_gemm.cuh's item walk), checked on the CPU: every output
block of every main-path shape is covered exactly once, whatever the card's
SM count. The kernels themselves are held against their plain versions in
tests/test_torch_cuda.py."""
from repro_torch.kernels import cvmm as K

# (M_pad, K_pad, N_pad, glu, save) of the main paths' calls
SHAPES = {
    "decode_w1": (5120, 1536, 512, False, False),              # granite-moe, one token
    "decode_w2": (5120, 512, 1536, False, False),
    "decode_8_lanes_w1": (40 * 512, 1536, 512, False, False),
    "prefill_chunk_w1": (81920, 1536, 512, False, False),      # serve-long, 256 tokens
    "prefill_chunk_w2": (81920, 512, 1536, False, False),
    "training_k1_forward": (34944, 512, 128, False, True),     # wt103-47m-moe
    "training_k1_t0": (34944, 512, 512, False, False),
    "training_k4_dx": (34944, 128, 512, False, False),
    "training_k2": (34944, 128, 512, False, False),            # y = (u w2) * gate
    "training_k4_unfused_w1": (34944, 512, 128, False, False),
    "k1_glu_save": (34944, 512, 128, True, True),
    "k1_glu": (2048, 128, 384, True, False),
    "one_tile": (128, 128, 128, False, False),
}


def test_row_gemm_walk_covers_every_output_block_once():
    # One test over every shape and SM count, not a parametrised one: this
    # file stays last in pytest-xdist's queue (ordered by tests a file), so
    # it leaves the order in which the other files reach the workers alone.
    for shape, (m_pad, k_pad, n_pad, glu, save) in SHAPES.items():
        for n_sms in (1, 7, 132):
            case = f"{shape} on {n_sms} SMs"
            bn, items, grid = K.row_gemm_schedule(m_pad, k_pad, n_pad, n_sms, glu=glu,
                                                  save=save)
            assert bn in (64, 128, 256) and n_pad % bn == 0, case
            assert (not glu or bn == 64) and (not save or bn <= 128), case
            assert items == (m_pad // K.TM) * (n_pad // bn), case
            assert 1 <= grid <= min(items, n_sms), case
            walks = [K.row_gemm_block_items(b, n_pad, (bn, items, grid)) for b in range(grid)]
            seen = {}
            for walk in walks:
                assert walk, f"{case}: a block of the grid has no item"
                for tile_col in walk:
                    seen[tile_col] = seen.get(tile_col, 0) + 1
            want = {(t, c) for t in range(m_pad // K.TM) for c in range(0, n_pad, bn)}
            assert set(seen) == want and set(seen.values()) == {1}, case
            loads = [len(walk) for walk in walks]
            assert max(loads) - min(loads) <= 1, f"{case}: not balanced to one item"


def test_row_gemm_schedule_narrows_items_for_small_grids():
    # decode's w1 on an H100: 160 items of 128 columns for 132 SMs would leave
    # most SMs one item, so the walk takes 64-wide ones; the prefill chunk's
    # 2,560 items of 128 leave room for 256-wide ones
    assert K.row_gemm_schedule(5120, 1536, 512, 132)[0] == 64
    assert K.row_gemm_schedule(5120, 512, 1536, 132)[0] == 128
    assert K.row_gemm_schedule(81920, 1536, 512, 132)[0] == 256
    assert K.row_gemm_schedule(81920, 1536, 512, 132, save=True)[0] == 128
    assert K.row_gemm_schedule(81920, 1536, 512, 132, glu=True)[0] == 64
    assert K.row_gemm_schedule(34944, 512, 128, 132)[0] == 128
    # a reduction of two 64-deep slices (training's K2 and K4 dX, K_pad 128)
    # keeps items 128 wide; at K_pad 512 the same call takes 256-wide ones
    assert K.row_gemm_schedule(34944, 128, 512, 132)[0] == 128
    assert K.row_gemm_schedule(34944, 512, 512, 132)[0] == 256
