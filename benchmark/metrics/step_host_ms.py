"""Host milliseconds a call of ``train_step_ids`` takes to return, without
a sync (what the host spends to issue a micro-step), averaged over the
traced window's calls."""


def read(run):
    calls = run.calls.get("train_step_ids")
    if not calls:
        return None
    return 1e3 * run.host_s["train_step_ids"] / len(calls)
