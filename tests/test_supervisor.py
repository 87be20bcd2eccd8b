"""Unit tests for pcx.supervisor — the sweep supervision layer.

These pin the watchdog/budget semantics that keep reference-resolution
band sweeps alive across worker faults, with fake clocks/processes so
every scenario runs in milliseconds.  The resume-grace test is a
regression for a real bug: the watchdog counted its first stat() of a
PRE-EXISTING checkpoint as progress, collapsing the first-write grace to
the steady-state stall timeout and killing every resumed worker while it
was still compiling.
"""

import json

import pytest

from pcx.supervisor import (SuperviseConfig, library_status, supervise)


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def sleep(self, dt):
        self.now += dt


class FakeWorld:
    """Scripted worker + checkpoint filesystem driven by the fake clock.

    ``script`` is a list of (time, event) with events:
      ("write", pending, failed)  — checkpoint write at that time
      ("exit", rc)                — worker exits at that time
    Each spawn consumes events from where the clock currently is.
    """

    def __init__(self, clock, script, initial_state=(None, None),
                 initial_mtime=None, initial_hb_mtime=None):
        self.clock = clock
        self.script = sorted(script)
        self.state = initial_state
        self.mtime = initial_mtime
        self.hb_mtime = initial_hb_mtime
        self.spawned = 0
        self.kills = 0
        self.reaped = 0
        self._proc = None

    # --- filesystem ------------------------------------------------------
    def getmtime(self, path):
        self._advance()
        mt = self.hb_mtime if path == "hb" else self.mtime
        if mt is None:
            raise OSError(path)
        return mt

    def status(self, path, lattice, n):
        self._advance()
        return self.state

    # --- process ---------------------------------------------------------
    def spawn(self):
        # a killed worker must be reaped before the next one starts
        assert self.reaped >= self.kills, "spawned before reaping a kill"
        self.spawned += 1
        world = self

        class P:
            returncode = None

            def poll(self):
                world._advance()
                return self.returncode

            def kill(self):
                world.kills += 1
                world._proc = None
                self.returncode = -9

            def wait(self):
                world.reaped += 1
                return self.returncode

        self._proc = P()
        return self._proc

    def _advance(self):
        while self.script and self.script[0][0] <= self.clock.now:
            t, ev = self.script.pop(0)
            if ev[0] == "write":
                self.mtime = t
                self.state = (ev[1], ev[2])
            elif ev[0] == "beat":
                self.hb_mtime = t
            elif ev[0] == "exit":
                if self._proc is not None:
                    self._proc.returncode = ev[1]
                    self._proc = None


def run(world, clock, cfg, **kw):
    return supervise(world.spawn, "lib.json", "sc_curv", 8, cfg,
                     clock=clock, sleep=clock.sleep,
                     getmtime=world.getmtime, status_fn=world.status,
                     log=lambda *_: None, **kw)


CFG = SuperviseConfig(max_rounds=3, outage_budget=1000.0, stall=900.0,
                      stall_grace=2400.0, release_sleep=10.0, poll=15.0)


def test_resume_grace_not_collapsed_by_preexisting_checkpoint():
    """Regression: with a pre-existing checkpoint (mtime in the past), the
    first poll must NOT count as progress — the worker gets the full
    stall_grace for its start-up compile, then writes at t=2000 and
    completes."""
    clock = FakeClock()
    world = FakeWorld(clock,
                      script=[(2000, ("write", [], [])), (2010, ("exit", 0))],
                      initial_state=([3], []), initial_mtime=-500.0)
    out = run(world, clock, CFG)
    assert out.ok and out.status == "complete"
    assert world.kills == 0, \
        "resume-grace regression: worker killed inside stall_grace"
    assert world.spawned == 1


def test_steady_state_stall_kill_and_resume():
    """A worker that writes once then hangs forever is killed `stall`
    seconds after its last write, and a fresh round is spawned."""
    clock = FakeClock()
    world = FakeWorld(clock, script=[(100, ("write", [5], []))],
                      initial_state=([5, 6], []))
    cfg = SuperviseConfig(max_rounds=1, outage_budget=1e9, stall=900.0,
                          stall_grace=2400.0, release_sleep=1.0, poll=15.0)
    out = run(world, clock, cfg)
    assert out.stall_kills >= 1
    assert out.rounds_used == 1          # the round WAS productive
    assert out.status == "rounds-exhausted"
    # kill happened ~stall after the write, well before grace expiry + write
    assert 900.0 <= clock.now - 1.0      # sanity: time actually advanced


def test_outage_attempts_do_not_burn_round_budget():
    """Workers that exit without touching the checkpoint burn the outage
    budget, not max_rounds."""
    clock = FakeClock()
    # Every spawn exits 100 s later with rc=1, never writing.
    script = [(100 * i, ("exit", 1)) for i in range(1, 50)]
    world = FakeWorld(clock, script=script, initial_state=([1], []),
                      initial_mtime=0.0)
    cfg = SuperviseConfig(max_rounds=3, outage_budget=350.0, stall=900.0,
                          stall_grace=2400.0, release_sleep=5.0, poll=15.0)
    out = run(world, clock, cfg)
    assert out.status == "outage-exhausted"
    assert out.rounds_used == 0
    assert out.outage_spent >= 350.0
    assert world.spawned >= 3


def test_completion_mid_round():
    clock = FakeClock()
    world = FakeWorld(clock,
                      script=[(50, ("write", [], [])), (60, ("exit", 0))],
                      initial_state=([0, 1], []), initial_mtime=0.0)
    out = run(world, clock, CFG)
    assert out.ok
    assert out.pending == [] and out.failed == []


def test_productive_rounds_exhaust_on_persistent_failures():
    """A deterministic per-k failure (worker always leaves a [-1,-1]
    record) consumes productive rounds and ends as rounds-exhausted."""
    clock = FakeClock()
    # Each round makes progress (the failing index alternates, so the
    # state always differs from the round's start) but never completes.
    script = [(50, ("write", [], [7])), (60, ("exit", 2)),
              (150, ("write", [], [8])), (160, ("exit", 2)),
              (250, ("write", [], [7])), (260, ("exit", 2))]
    world = FakeWorld(clock, script=script, initial_state=([7, 8], []),
                      initial_mtime=0.0)
    cfg = SuperviseConfig(max_rounds=2, outage_budget=1e9, stall=900.0,
                          stall_grace=2400.0, release_sleep=1.0, poll=15.0)
    out = run(world, clock, cfg)
    assert out.status == "rounds-exhausted"
    assert out.rounds_used == 2
    assert out.failed  # the persistent failure is reported


def test_library_status_roundtrip(tmp_path):
    lib = {"sc_curv_16_iterations": [[5, 1.0], [0, 0], [-1, -1], [3, 0.5]],
           "sc_curv_16_frequencies": [[0.1] * 10] * 4}
    p = tmp_path / "bandgap_sc_curv.json"
    p.write_text(json.dumps(lib))
    pending, failed = library_status(str(p), "sc_curv", 16)
    assert pending == [1] and failed == [2]
    assert library_status(str(tmp_path / "nope.json"), "sc_curv", 16) \
        == (None, None)


# outage_budget=1: a killed round that changed nothing exhausts the outage
# budget immediately, so each scenario stops after its FIRST kill and
# clock.now reads the kill time.
HB_CFG = SuperviseConfig(max_rounds=1, outage_budget=1.0, stall=900.0,
                         stall_grace=2400.0, release_sleep=1.0, poll=15.0,
                         hb_path="hb", hb_stall=420.0)


def test_heartbeat_silence_kills_hung_worker_fast():
    """Stall injection: a worker that beats once then
    hangs mid-RPC is killed ~hb_stall after its last beat — NOT at the end
    of the 2400 s startup grace (the c26 window lost 40 min this way)."""
    clock = FakeClock()
    world = FakeWorld(clock, script=[(100, ("beat",))],
                      initial_state=([5], []), initial_mtime=0.0)
    out = run(world, clock, HB_CFG)
    assert out.stall_kills >= 1
    assert world.kills >= 1
    # first kill must land near 100 + hb_stall, far inside the old grace
    assert clock.now < 1500.0, clock.now


def test_heartbeat_keeps_long_beatless_checkpoint_alive():
    """A worker beating every 20 s (device iterating on a long/doomed
    solve) must NOT be killed even though the checkpoint JSON has not
    advanced for far longer than `stall`."""
    clock = FakeClock()
    script = [(20.0 * i, ("beat",)) for i in range(1, 100)]
    script += [(2000, ("write", [], [])), (2005, ("exit", 0))]
    cfg = SuperviseConfig(max_rounds=1, outage_budget=1e9, stall=300.0,
                          stall_grace=600.0, release_sleep=1.0, poll=15.0,
                          hb_path="hb", hb_stall=420.0)
    world = FakeWorld(clock, script=script, initial_state=([3], []),
                      initial_mtime=0.0)
    out = run(world, clock, cfg)
    assert out.ok, out.status
    assert world.kills == 0, "live worker killed despite heartbeats"


def test_fully_hung_worker_bounded_by_grace():
    """No beat, no write, no exit: killed exactly once the startup grace
    expires (the heartbeat watchdog cannot shrink the start-up compile
    allowance, only a real beat can)."""
    clock = FakeClock()
    world = FakeWorld(clock, script=[], initial_state=([5], []),
                      initial_mtime=0.0)
    out = run(world, clock, HB_CFG)
    assert out.stall_kills >= 1
    assert 2400.0 <= clock.now < 3000.0, clock.now


def test_stale_heartbeat_from_previous_round_not_progress():
    """A stale hb file (previous round's beats) must not count as liveness:
    the new worker never beats, so it is killed at grace expiry, not kept
    alive by the old mtime."""
    clock = FakeClock()
    world = FakeWorld(clock, script=[], initial_state=([5], []),
                      initial_mtime=0.0, initial_hb_mtime=-50.0)
    out = run(world, clock, HB_CFG)
    assert out.stall_kills >= 1
    assert 2400.0 <= clock.now < 3000.0, clock.now


def test_run_sweep_tool_uses_supervisor():
    """The production tool must route through the tested supervisor."""
    import importlib.util
    import pathlib
    src = (pathlib.Path(__file__).resolve().parents[1]
           / "tools" / "run_sweep.py").read_text()
    assert "from pcx.supervisor import" in src
    assert "supervise(" in src


def test_killed_worker_reaped_before_respawn():
    """A stall-killed worker is waited on before the next round spawns
    (one process per card: the killed one must release the device)."""
    clock = FakeClock()
    world = FakeWorld(clock, script=[], initial_state=([5], []),
                      initial_mtime=0.0)
    cfg = SuperviseConfig(max_rounds=3, outage_budget=6000.0, stall=900.0,
                          stall_grace=100.0, release_sleep=1.0, poll=15.0)
    out = run(world, clock, cfg)
    assert world.kills >= 2 and world.spawned == world.kills
    assert world.reaped == world.kills
    assert out.stall_kills == world.kills
