"""The control at a size a test run holds: the reference computed in
float8 in the program's place fails one of the configuration's limits on
every seed, where the program passes both, each over the rows the tie
rule judges."""
import pytest
import torch

from portbench import control


@pytest.mark.parametrize("cell", ["tiny-d", "tiny-h", "tiny-m"])
def test_the_control_fails_a_limit_the_program_passes(tiny_root, cell):
    import json
    from portbench import harness
    bench = harness.read_json(tiny_root / "BENCHMARK.json")
    cfg = json.loads((tiny_root / "portbench" / "configs" /
                      f"{harness.cell_entry(bench, cell)['config']}.json")
                     .read_text())
    limit = {"gap": cfg["check"]["gap_limit"],
             "logit_err": cfg["check"]["logit_limit"]}
    tied_limit = cfg["check"].get("tied_limit", 0.0)
    recs = control.readings(tiny_root, cell, [11, 12, 13], 30.0,
                            device=torch.device("cpu"), kernel_mode="torch",
                            index_mode="torch", log=lambda m: None)
    assert all(r["failed"] == 0 and r["rows"] > 0 for r in recs)
    for r in recs:
        assert r["tied_share"] <= tied_limit
        assert all(r[f"program_{n}"] <= lim for n, lim in limit.items())
        assert any(r[f"control_{n}"] > lim for n, lim in limit.items())
