"""The FLOP and byte formulas of the references against hand counts."""

from gpubench.reference import equiformer_v2, gcn_cora

GCN = {"n_layers": 2, "d_in": 12, "d_hidden": 8, "n_classes": 5}
EQV2 = {"n_layers": 2, "d_hidden": 16, "l_max": 2, "m_max": 1,
        "n_heads": 4, "d_in": 8, "d_out": 1}


def test_gcn_flops_by_hand():
    # Layer 1: X W 2*400*12*8 = 76,800, A (XW) 2*3400*8 = 54,400;
    # layer 2: 2*400*8*5 = 32,000 and 2*3400*5 = 34,000; train 3x.
    assert gcn_cora.flops(GCN, 400, 3400) == 3 * (76_800 + 54_400
                                                  + 32_000 + 34_000)


def test_gcn_flops_at_ogbn_products():
    model = {"n_layers": 2, "d_in": 100, "d_hidden": 16, "n_classes": 47}
    n, e = 2_449_029, 61_859_140 + 2_449_029
    assert gcn_cora.flops(model, n, e) == 3 * (n * (2 * 100 * 16 + 2 * 16 * 47)
                                               + e * (2 * 16 + 2 * 47))
    assert round(gcn_cora.flops(model, n, e) / 1e9, 1) == 58.9


def test_gcn_aggregate_bytes_by_hand():
    # A layer of width b: N rows read and N written (4 bytes a float),
    # each edge's two int64 ids and f32 weight; forward and backward.
    per_8 = 2 * 400 * 8 * 4 + 3400 * 20
    per_5 = 2 * 400 * 5 * 4 + 3400 * 20
    assert gcn_cora.aggregate_bytes(GCN, 400, 3400) == 2 * (per_8 + per_5)


def test_equiformer_flops_by_hand():
    # m_dim by degree: 1, 3, 3; rotation MACs an edge and channel
    # 1*1 + 3*3 + 3*5 = 25, so 400 with 16 channels, twice (and back).
    # SO(2): m = 0 over 3 degrees x 16 = 48 squared, 2,304; m = 1 over
    # 2 degrees, 32 wide, four real products, 4,096.  The attention's
    # second product 16 x 4 heads = 64.  An edge: 800 + 6,400 + 64.
    # A node: the attention's first product 2 * 16 * 16, the gates
    # 16 * 32, the FFN 16 * 32 + 32 * 16: 2,048.
    per_edge, per_node = 800 + 2_304 + 4_096 + 64, 512 + 512 + 1_024
    macs = (100 * 8 * 16 + 2 * (300 * per_edge + 100 * per_node)
            + 16 * 16 + 16 * 1)
    assert equiformer_v2.flops(EQV2, 100, 300) == 3 * 2 * macs


def test_equiformer_aggregate_bytes_by_hand():
    # A row is 9 x 16 f32 = 576 bytes; the gather reads 100 rows and
    # writes 300, the scatter reads 300 and writes 100, each reads 300
    # int64 ids; forward and backward; 2 layers.
    per = (100 * 576 + 300 * 576 + 300 * 8) * 2
    assert equiformer_v2.aggregate_bytes(EQV2, 100, 300) == 2 * 2 * per
