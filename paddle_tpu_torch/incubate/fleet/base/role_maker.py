"""Role makers: who am I in the distributed job.

Counterpart of ``paddle_tpu/incubate/fleet/base/role_maker.py`` (the
reference's ``role_maker.py``: ``PaddleCloudRoleMaker``'s env contract and
``UserDefinedRoleMaker``). The classes answer from the PADDLE_* env vars
the launcher (``distributed/launch.py``) sets.
"""
from __future__ import annotations

import os


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._role = Role.WORKER
        self._current_id = 0
        self._worker_endpoints = []
        self._server_endpoints = []
        self._role_is_generated = False

    def generate_role(self):
        raise NotImplementedError

    def _ensure(self):
        if not self._role_is_generated:
            self.generate_role()

    def is_worker(self):
        self._ensure()
        return self._role == Role.WORKER

    def is_server(self):
        self._ensure()
        return self._role == Role.SERVER

    def is_first_worker(self):
        self._ensure()
        return self._role == Role.WORKER and self._current_id == 0

    def worker_index(self):
        self._ensure()
        return self._current_id

    def server_index(self):
        self._ensure()
        return self._current_id

    def worker_num(self):
        self._ensure()
        return len(self._worker_endpoints) or 1

    def server_num(self):
        self._ensure()
        return len(self._server_endpoints)

    def get_trainer_endpoints(self):
        self._ensure()
        return self._worker_endpoints

    def get_pserver_endpoints(self):
        self._ensure()
        return self._server_endpoints


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._worker_endpoints = ["127.0.0.1:0"] * worker_num
        self._server_endpoints = list(server_endpoints or [])
        self._worker_num = worker_num

    def worker_num(self):
        return self._worker_num

    def generate_role(self):
        self._role_is_generated = True


class PaddleCloudRoleMaker(RoleMakerBase):
    """Reads the PADDLE_* env contract set by launch tooling
    (reference role_maker.py:441)."""

    def __init__(self, is_collective=False):
        super().__init__()
        self._is_collective = is_collective

    def generate_role(self):
        if self._is_collective:
            self._role = Role.WORKER
            self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
            eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
            self._worker_endpoints = [e for e in eps.split(",") if e]
        else:
            training_role = os.environ.get("TRAINING_ROLE", "TRAINER")
            if training_role == "TRAINER":
                self._role = Role.WORKER
                self._current_id = int(
                    os.environ.get("PADDLE_TRAINER_ID", "0"))
            else:
                self._role = Role.SERVER
            eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
            self._server_endpoints = [e for e in eps.split(",") if e]
            if self._role == Role.SERVER:
                # reference role_maker.py:477: server id = index of this
                # host's POD_IP:PADDLE_PORT in the endpoint list
                cur = "%s:%s" % (os.environ.get("POD_IP", ""),
                                 os.environ.get("PADDLE_PORT", ""))
                self._current_id = (self._server_endpoints.index(cur)
                                    if cur in self._server_endpoints else 0)
            self._worker_endpoints = ["w:%d" % i for i in range(int(
                os.environ.get("PADDLE_TRAINERS_NUM", "1")))]
        self._role_is_generated = True
