"""Tiny cells for the CPU tests: the benchmark's two architectures and
traffic kinds at sizes a test run holds."""

OPTIMIZER = {"name": "adamw", "lr": 0.001, "b1": 0.9, "b2": 0.95,
             "eps": 1e-08, "clip": 1.0, "weight_decay": 0.0}
#: A tiny cell's limits: above its sound readings (float32 against the
#: float64 reference: loss 2e-06, leaf norms 3e-06 at most), below each
#: fault's (1e-03 and up).
LIMITS = {"loss_step1": 1e-04, "grad": 1e-04, "delta": 1e-03}


def gcn() -> dict:
    return {"name": "tiny-gcn", "chips": 1, "limits": dict(LIMITS),
            "config": {
                "arch": "gcn-cora", "shape": "ogb_products",
                "dtype": "float32", "optimizer": dict(OPTIMIZER),
                "model": {"n_layers": 2, "d_in": 12, "d_hidden": 8,
                          "n_classes": 5, "norm": "sym"},
                "graph": {"n_nodes": 400, "n_edges": 3000, "d_feat": 12,
                          "n_classes": 5, "law": "power_law",
                          "degree_exponent": 3.0, "symmetric": True,
                          "self_loops": True}},
            "traffic": {"kind": "full_batch"},
            "metrics": {"end_to_end": [], "per_layer": []}}


def equiformer() -> dict:
    return {"name": "tiny-eqv2", "chips": 1, "limits": dict(LIMITS),
            "config": {
                "arch": "equiformer-v2", "shape": "minibatch_lg",
                "dtype": "float32", "optimizer": dict(OPTIMIZER),
                "model": {"n_layers": 2, "d_hidden": 16, "l_max": 2,
                          "m_max": 1, "n_heads": 4, "d_in": 8, "d_out": 1,
                          "edge_chunks": 1},
                "graph": {"n_nodes": 600, "n_edges": 20000, "d_feat": 8,
                          "law": "power_law", "degree_exponent": 3.0,
                          "self_loops": False}},
            "traffic": {"kind": "sampled", "seeds": 8, "fanout": [3, 2],
                        "pool": 4},
            "metrics": {"end_to_end": [], "per_layer": []}}
