"""Multi-host serving control plane (SURVEY §7 stage 8, BASELINE
config 5's host-coordination half): a leader app assigning ranks to
worker hosts, gossiping health, evicting the dead, and driving elastic
relaunches.

Run the leader:   python main.py            (serves /control/*)
Run a worker:     python main.py worker h1  (joins + heartbeats)

On a real cluster each worker's ``on_assignment`` callback calls
``torch.distributed.init_process_group(**assignment.dist_init_args())``
and relaunches the mesh-sharded engine; here it prints the assignment.
"""

import sys

from gofr_tpu_torch.app import App, new_app
from gofr_tpu_torch.serving.control_plane import ControlPlaneLeader, WorkerAgent


def build_app(config=None, coordinator: str = "10.0.0.1:8476") -> App:
    app = new_app() if config is None else App(config=config)
    leader = ControlPlaneLeader(coordinator=coordinator,
                                heartbeat_interval_s=2.0,
                                logger=app.logger)
    leader.install(app)
    return app


def run_worker(leader_url: str, host_id: str) -> WorkerAgent:
    def on_assignment(assignment):
        print(f"[{host_id}] generation {assignment.generation}: "
              f"rank {assignment.rank}/{assignment.world_size} "
              f"-> torch.distributed.init_process_group("
              f"{assignment.dist_init_args()})")

    worker = WorkerAgent(leader_url, host_id=host_id, n_devices=4,
                         on_assignment=on_assignment)
    worker.start()
    return worker


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        agent = run_worker("http://127.0.0.1:8000",
                           sys.argv[2] if len(sys.argv) > 2 else "host-1")
        import time
        while True:
            time.sleep(60)
    else:
        build_app().run()
