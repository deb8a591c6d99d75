"""Fleet interface (the reference's incubate/fleet/base/fleet_base.py:38;
counterpart of ``paddle_tpu/incubate/fleet/base/fleet_base.py``).

The abstract surface user scripts program against: init(role),
is_worker()/is_server(), distributed_optimizer(), save_*; the collective
mode (``collective/``) subclasses it.
"""
from __future__ import annotations

import abc

from .role_maker import PaddleCloudRoleMaker, RoleMakerBase


class Fleet(metaclass=abc.ABCMeta):
    def __init__(self, mode):
        self._is_initialized = False
        self._mode = mode
        self._optimizer = None
        self._role_maker = None
        self._executor = None

    def init(self, role_maker=None):
        if role_maker is None:
            role_maker = PaddleCloudRoleMaker(
                is_collective=(self._mode == "collective"))
        if not isinstance(role_maker, RoleMakerBase):
            raise TypeError("role_maker must be a RoleMakerBase")
        self._role_maker = role_maker
        role_maker.generate_role()
        self._is_initialized = True

    def _check_init(self):
        if not self._is_initialized:
            raise RuntimeError("fleet.init(role) must be called first")

    def is_first_worker(self):
        self._check_init()
        return self._role_maker.is_first_worker()

    def worker_index(self):
        self._check_init()
        return self._role_maker.worker_index()

    def worker_num(self):
        self._check_init()
        return self._role_maker.worker_num()

    def is_worker(self):
        self._check_init()
        return self._role_maker.is_worker()

    def server_num(self):
        self._check_init()
        return self._role_maker.server_num()

    def server_index(self):
        self._check_init()
        return self._role_maker.server_index()

    def is_server(self):
        self._check_init()
        return self._role_maker.is_server()

    def worker_endpoints(self):
        self._check_init()
        return self._role_maker.get_trainer_endpoints()

    def server_endpoints(self):
        self._check_init()
        return self._role_maker.get_pserver_endpoints()

    @abc.abstractmethod
    def distributed_optimizer(self, optimizer, strategy=None):
        ...

    @abc.abstractmethod
    def init_worker(self):
        ...

    @abc.abstractmethod
    def init_server(self, model_dir=None):
        ...

    @abc.abstractmethod
    def run_server(self):
        ...

    @abc.abstractmethod
    def stop_worker(self):
        ...

    @abc.abstractmethod
    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        ...

    @abc.abstractmethod
    def save_persistables(self, executor, dirname, main_program=None):
        ...


class DistributedOptimizer(metaclass=abc.ABCMeta):
    def __init__(self, optimizer, strategy=None):
        self._optimizer = optimizer
        self._strategy = strategy

    @abc.abstractmethod
    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        ...
