"""Host ms of one ``BCNNEngine.step`` (admission, the slot copy, the graph
replay, the logits copy back, completion), the harness's clock around each
step, over every step of the window outside the traced slice."""


def read(run):
    r = run.record
    if not r.get("steps_out"):
        return None
    return r["step_s_out"] * 1e3 / r["steps_out"]
