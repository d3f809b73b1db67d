"""``chip_smoke.py``'s rows of replayed steps on the CPU, with their clocks
stubbed: a serve row's idle share is taken against its profiled window's
own host ms, as a train row's is (busy and host time from one window), so
a busy time longer than the turns' step ms can no longer read a share
below 0."""
import pytest

import chip_smoke as cs


def stub_clocks(monkeypatch, step_ms, window_ms, busy_ms):
    monkeypatch.setattr(cs, "timed_steps", lambda steps, n: {
        k: (step_ms, [step_ms, step_ms]) for k in steps})

    def profile(step, n, window=None):
        if window is not None:
            window.append(window_ms)
        return busy_ms, 397.0, [{"kernel": "k", "ms_per_step": busy_ms}], \
            {"k": n}
    monkeypatch.setattr(cs, "profile_steps", profile)


@pytest.mark.parametrize("step_ms,window_ms,busy_ms", [
    (6.109, 6.2, 6.142),      # busy past the turns' step ms (merged 256)
    (8.157, 8.4, 8.306),
    (4.464, 4.5, 4.257)])
def test_a_serve_row_s_idle_share_is_its_profiled_window_s(
        monkeypatch, step_ms, window_ms, busy_ms):
    stub_clocks(monkeypatch, step_ms, window_ms, busy_ms)
    rows = cs.serve_step_rows({"hsz256_merged_graph": lambda: None})
    row = rows["hsz256_merged_graph"]
    assert row["step_ms"] == step_ms and row["device_busy_ms"] == busy_ms
    assert row["profiled_step_ms"] == window_ms
    assert row["device_idle_share"] == pytest.approx(1 - busy_ms / window_ms)
    assert row["device_idle_share"] >= 0


def test_the_window_s_share_is_none_without_kernels(monkeypatch):
    stub_clocks(monkeypatch, 5.0, 5.5, None)
    busy, launches, top, names, window_ms, idle = cs.profiled_window(
        lambda: None, 3)
    assert busy is None and idle is None and window_ms == 5.5
