"""The general training loop: the port of the JAX package's
``training/trainer.py:Trainer`` (reference ``alegnn/modules/training.py``,
:29-578).

Minibatches with an uneven last batch, a per-epoch permutation from
``np.random.default_rng(seed)`` (the batch order of the JAX Trainer),
validation every ``validationInterval`` steps under ``torch.no_grad()``,
Best checkpoints on validation, early stopping, resume from Last, a JSONL
metrics file, and a staircase learning-rate decay. A step is eager
PyTorch: forward, loss, ``backward`` (through the kernels' autograd
Functions on a band/bcsr GSO), optimizer step. A stochastic forward (a
``split_forward`` that takes ``generator``: the GRNNs' z0) draws from the
trainer's ``torch.Generator``, seeded from ``seed`` on the model's device
and advancing every step, as the JAX Trainer splits its key a step;
validation draws from a fresh generator seeded 0, as JAX's PRNGKey(0).

``mesh=`` (a ``parallel.Mesh``) and ``meshAxis=`` follow the JAX
Trainer's data-parallel semantics: the batch split over the mesh's data
axis, the parameters replicated, a step equal to the single-device step.
The port is single-controller and its meshes may repeat one device: the
batch goes to the mesh's home device, and a model sharded on the same mesh
(``arch.shard(mesh, n_parts, data_axis=...)``) splits it over the data
axis in its sharded operators (the ``rows`` of
``ShardedBandAttention.apply``, ``ShardedGso``'s ``data_axis``). A mesh
over devices other than the model's needs replicas on several cards and a
gradient all-reduce (ROADMAP queue 1 item 10.2b) and raises.

``TrainerFlocking`` trains the flocking controller with DAGger over the
host-numpy store (``Flocking(...)``, ``Flocking.large``) or the
device-resident one (``Flocking.large_device``: the grid kernels recompute
each batch's supervision). Not ported yet: ``TrainerSingleNode``, bf16
mixed precision (``precision="bf16"``: the kernels take f32 only).
``scanDispatch`` and ``scanMemoryBudget`` (the JAX Trainer's
many-steps-in-one-dispatch scan) are accepted and have no effect: PyTorch
dispatches each step eagerly, and CUDA graphs would be the tool for that
overhead.
"""

from __future__ import annotations

import inspect
import os
import pickle
import time
import warnings

import numpy as np
import torch

from graph_neural_networks_torch.ops.ell import (
    EllGso, ell_from_dense, ell_to_dense)
from graph_neural_networks_torch.utils.misc import append_jsonl


def _batch_bounds(n_train: int, batch_size) -> list:
    """Batch index bounds with uneven last batch
    (reference training.py:176-200)."""
    if isinstance(batch_size, int):
        if n_train < batch_size:
            sizes = [n_train]
        else:
            n_batches = int(np.ceil(n_train / batch_size))
            sizes = [batch_size] * n_batches
            if sum(sizes) != n_train:
                sizes[-1] = n_train - sum(sizes[:-1])
    else:
        sizes = list(batch_size)
    return [0] + [int(b) for b in np.cumsum(sizes)]


def _takes_generator(fn) -> bool:
    """True for a stochastic forward (a GRNN's, which draws z0) that takes
    a ``generator``."""
    try:
        return "generator" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def staircase_decay(rate: float, period_steps: int):
    """The schedule of optax.exponential_decay(lr, period_steps, rate,
    staircase=True) as a StepLR factory (stepped once a training step):
    lr at step s = lr * rate ** (s // period_steps)."""
    return lambda opt: torch.optim.lr_scheduler.StepLR(
        opt, step_size=period_steps, gamma=rate)


class Trainer:

    def __init__(self, model, data, nEpochs: int, batchSize: int, **kwargs):
        self.model = model
        self.data = data
        self.nEpochs = nEpochs
        self.batchSize = batchSize
        self.validationInterval = kwargs.get("validationInterval",
                                             max(data.nTrain // batchSize, 1))
        self.printInterval = kwargs.get("printInterval", 0)
        self.doPrint = self.printInterval > 0
        self.earlyStoppingLag = kwargs.get("earlyStoppingLag", 0)
        self.doEarlyStopping = self.earlyStoppingLag > 0
        self.learningRateDecayRate = kwargs.get("learningRateDecayRate")
        self.learningRateDecayPeriod = kwargs.get("learningRateDecayPeriod")
        self.doSaveVars = kwargs.get("doSaveVars", False)
        self.metricsFile = kwargs.get("metricsFile")
        self.logger = kwargs.get("logger")  # a Visualizer-like scalar logger
        self.resume = kwargs.get("resume", False)
        # scanDispatch and scanMemoryBudget are accepted and ignored
        self.device = next(iter(model.archit.parameters())).device
        self.mesh = kwargs.get("mesh")
        self.meshAxis = kwargs.get("meshAxis")
        if self.mesh is not None:
            self._check_mesh()
        self.precision = kwargs.get("precision")
        if self.precision == "bf16":
            raise NotImplementedError(
                "Trainer(precision='bf16'): bf16 training is not ported "
                "(ROADMAP queue 1, bf16 training); the kernels take f32")
        if self.precision not in (None, "f32"):
            raise ValueError(f"unknown precision {self.precision!r}")
        self.rng = np.random.default_rng(kwargs.get("seed", 0))
        # stochastic forwards (a GRNN's z0 ~ N(0, 1) each call) draw from
        # the trainer's generator, which advances every step; validation
        # draws from a fresh one seeded 0, as the JAX Trainer's PRNGKey(0)
        self.generator = (
            torch.Generator(device=self.device).manual_seed(
                kwargs.get("seed", 0))
            if _takes_generator(model.archit.split_forward) else None)

    def _check_mesh(self):
        """Accept a parallel.Mesh all of whose devices are the model's
        (the single controller's replicas share its parameters); default
        meshAxis to the mesh's first axis, as the JAX Trainer does."""
        from graph_neural_networks_torch.parallel.mesh import (
            Mesh, normalize_device)
        mesh = self.mesh
        if not isinstance(mesh, Mesh):
            raise TypeError(f"Trainer(mesh=...) takes a "
                            f"graph_neural_networks_torch.parallel.Mesh, got "
                            f"{type(mesh).__name__}")
        if self.meshAxis is None:
            self.meshAxis = mesh.axis_names[0]
        if self.meshAxis not in mesh.axis_names:
            raise ValueError(f"meshAxis {self.meshAxis!r} is not an axis of "
                             f"{mesh}")
        others = {d for d in mesh.devices.flat
                  if d != normalize_device(self.device)}
        if others:
            raise NotImplementedError(
                f"Trainer(mesh=...) over devices {sorted(map(str, others))} "
                f"besides the model's {self.device}: data-parallel replicas "
                "on several devices with a gradient all-reduce are not "
                "ported yet (ROADMAP queue 1 item 10.2b)")

    # -- one step ----------------------------------------------------------
    def _forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        if generator is not None:
            return self.model.archit.split_forward(x, generator=generator)[0]
        return self.model.archit.split_forward(x)[0]

    def _to_device(self, x, y):
        """The batch as the step takes it: f32 signals; integer targets
        kept, floating ones in f32 (as the JAX step's jnp.asarray)."""
        x = torch.as_tensor(np.asarray(x), dtype=torch.float32,
                            device=self.device)
        y = torch.as_tensor(np.asarray(y), device=self.device)
        if y.is_floating_point():
            y = y.float()
        return x, y

    def train_batch(self, idx):
        x, y = self._to_device(*self.data.getSamples("train", idx))
        model = self.model
        t0 = time.perf_counter()
        model.optimizer.zero_grad(set_to_none=True)
        loss = model.loss(self._forward(x, self.generator).float(), y)
        loss.backward()
        model.optimizer.step()
        if model.scheduler is not None:
            model.scheduler.step()
        loss = loss.item()   # waits for the step
        return loss, time.perf_counter() - t0

    def _valid_cost(self) -> float:
        x, y = self.data.getSamples("valid")
        with torch.no_grad():
            yHat = self._forward(self._to_device(x, y)[0])
        return float(self.data.evaluate(yHat.cpu().numpy(), y))

    # -- the loop ----------------------------------------------------------
    def train(self):
        model, data = self.model, self.data
        n_train = data.nTrain
        bounds = _batch_bounds(n_train, self.batchSize)
        n_batches = len(bounds) - 1

        if (self.learningRateDecayRate is not None
                and self.learningRateDecayPeriod is not None
                and isinstance(model.optimizer_spec, dict)):
            model.rebuild_optimizer(staircase_decay(
                self.learningRateDecayRate,
                self.learningRateDecayPeriod * n_batches))

        loss_train, cost_valid, time_train = [], [], []
        best_score = None
        best_epoch = best_batch = 0
        lag = 0
        epoch = 0
        if self.resume:
            # pick up where 'Last' left off: epoch counter, RNG state,
            # best-score bookkeeping
            try:
                state = model.load("Last")
            except FileNotFoundError:
                state = None
            if state:
                epoch = state["next_epoch"]
                best_score = state["best_score"]
                best_epoch = state["best_epoch"]
                best_batch = state["best_batch"]
                lag = state["lag"]
                self.rng.bit_generator.state = state["np_rng"]
                loss_train = list(state["loss_train"])
                cost_valid = list(state["cost_valid"])

        def _loop_state():
            return {
                "next_epoch": epoch, "best_score": best_score,
                "best_epoch": best_epoch, "best_batch": best_batch,
                "lag": lag, "np_rng": self.rng.bit_generator.state,
                "loss_train": loss_train, "cost_valid": cost_valid,
            }

        def post_step(epoch, batch, loss, elapsed):
            """Record, print, log, validate/checkpoint/early-stop."""
            nonlocal best_score, best_epoch, best_batch, lag
            loss_train.append(loss)
            time_train.append(elapsed)
            step_no = epoch * n_batches + batch
            if self.doPrint and step_no % self.printInterval == 0:
                print(f"\t(E: {epoch + 1:2d}, B: {batch + 1:3d}) "
                      f"loss {loss:7.4f} - {elapsed:.4f}s")
            if self.logger is not None:
                self.logger.scalar_summary("Training", step_no,
                                           lossTrain=loss)
            if step_no % self.validationInterval == 0:
                cost = self._valid_cost()
                cost_valid.append(cost)
                if self.metricsFile:
                    append_jsonl(self.metricsFile, {
                        "step": step_no, "loss": loss, "valid_cost": cost})
                if self.logger is not None:
                    self.logger.scalar_summary("Validation", step_no,
                                               costValid=cost)
                if best_score is None or cost < best_score:
                    best_score = cost
                    best_epoch, best_batch = epoch, batch
                    model.save(label="Best")
                    lag = 0
                elif self.doEarlyStopping:
                    lag += 1

        def going():
            return lag < self.earlyStoppingLag or not self.doEarlyStopping

        while epoch < self.nEpochs and going():
            # the permutation is drawn before the epoch hook, as in the JAX
            # Trainer, so that a subclass's draws (DAGger) follow it
            perm = self.rng.permutation(n_train)
            self._on_epoch_start(epoch)
            batch = 0
            while batch < n_batches and going():
                idx = perm[bounds[batch]:bounds[batch + 1]]
                self._on_batch_start(epoch, batch, idx)
                loss, elapsed = self.train_batch(idx)
                post_step(epoch, batch, loss, elapsed)
                batch += 1
            epoch += 1
            # per-epoch resumable checkpoint (params + opt + loop state)
            model.save(label="Last", extra=_loop_state())

        model.save(label="Last", extra=_loop_state())
        if best_score is not None:
            model.load(label="Best")  # reference reloads Best at end (:571)
        train_vars = {
            "nEpochs": self.nEpochs, "nBatches": n_batches,
            "batchSize": self.batchSize, "lossTrain": np.array(loss_train),
            "costValid": np.array(cost_valid),
            "timeTrain": np.array(time_train),
            "bestScore": best_score, "bestEpoch": best_epoch,
            "bestBatch": best_batch,
        }
        if self.doSaveVars:
            d = os.path.join(model.saveDir, "trainVars")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"{model.name}.pkl"), "wb") as f:
                pickle.dump(train_vars, f)
        return train_vars

    # hooks for subclasses
    def _on_epoch_start(self, epoch):
        pass

    def _on_batch_start(self, epoch, batch, idx):
        pass


class TrainerFlocking(Trainer):
    """Imitation learning of the expert flocking controller, with optional
    DAGger; validation is the closed-loop trajectory cost (JAX
    ``TrainerFlocking``; reference training.py:716-1696). Two stores:

    * The host store (the default): the dataset's states, expert labels and
      graphs as numpy, ``xAll``/``yAll``/``SAll`` and their ``Orig``
      copies; the graphs are the dense (n, T, N, N) stack of
      ``Flocking(...)`` or the EllGso with numpy leaves of
      ``Flocking.large``. A step uploads its batch (the dense graphs as ELL
      ones of width ellDegree when it is given) and runs the full-history
      forward, the loss, the backward and the optimizer step. DAGger
      ('randomEpoch', 'replaceTimeBatch' or 'fixedBatch', with
      ``probExpert``) re-rolls learner trajectories with
      ``Flocking.compute_trajectory`` through the policy's step interface
      (the JAX trainer's windowed re-forward equals it up to float
      association) and relabels them with the expert (:meth:`_expert_accel`,
      clipped at the dataset's accelMax, its T-1 label kept as JAX keeps
      it); fixedBatch appends a fresh rollout of the batch's initial
      conditions to every batch after the first. Re-rolled ELL graphs stay
      f32 in an ELL store (JAX hands them on in f64; the values are the
      same f32 ones) and are scattered to dense ones in a dense store.
    * The device store (``deviceStore=True``; no-DAGger, randomEpoch or
      replaceTimeBatch): only the (n, T, 2, N) pos/vel live on the device,
      and a step recomputes the batch's states, labels and graphs there
      without grad: on the grid kernels with ELL graphs of width ellDegree
      (``Flocking.large_device``; ``recompute_supervision_grid``), or all
      pairs with dense ones for a dataset without the grid
      (``recompute_supervision``). Re-rolls run
      ``Flocking.rollout_traj_device`` and validation is the device cost
      of one. Labels are zeroed at t = T-1 (the generation convention).
      Over the grid, a coverage check at construction recomputes every
      stored trajectory once and warns on a cell overflow or an in-degree
      above ellDegree (``coverageCheck=False`` skips it); it reads the
      in-degree from the window pass, which the JAX check does not: JAX
      misses an in-degree above ellDegree when no payload rides the table
      (ROADMAP queue 3).

    The DAGger selections draw from the trainer's numpy rng after the
    epoch's batch permutation, in JAX's order, so both pick the same
    learners.
    """

    def __init__(self, model, data, nEpochs, batchSize, **kwargs):
        self.probExpert = kwargs.get("probExpert")
        self.doDAGger = self.probExpert is not None
        self.DAGgerType = kwargs.get("DAGgerType", "randomEpoch")
        if self.doDAGger and self.DAGgerType not in (
                "randomEpoch", "replaceTimeBatch", "fixedBatch"):
            raise ValueError(f"unknown DAGgerType {self.DAGgerType!r}")
        self.ellDegree = kwargs.get("ellDegree")
        self.deviceStore = bool(kwargs.get("deviceStore", False))
        self.grid = getattr(data, "rollout_env_grid", None)
        if self.deviceStore:
            self._check_device_store(model)
        super().__init__(model, data, nEpochs, batchSize, **kwargs)
        self._step_count = 0
        self.initPosAll = data.getData("initPos", "train")
        self.initVelAll = data.getData("initVel", "train")
        if not self.deviceStore:
            # the training trajectories, kept in numpy; DAGger mutates them
            self.xAll, self.yAll = data.getSamples("train")
            self.SAll = self._S_copy(data.getData("commGraph", "train"))
            self.xOrig = self.xAll.copy()
            self.yOrig = self.yAll.copy()
            self.SOrig = self._S_copy(self.SAll)
            return
        self.posAll = torch.as_tensor(data.getData("pos", "train"),
                                      dtype=torch.float32, device=self.device)
        self.velAll = torch.as_tensor(data.getData("vel", "train"),
                                      dtype=torch.float32, device=self.device)
        # the store's originals; a re-roll writes into fresh copies
        self.posOrig, self.velOrig = self.posAll, self.velAll
        self.rolloutChunk = int(kwargs.get(
            "rolloutChunk", max(1, min(16, data.nTrain))))
        if self.grid is not None and kwargs.get("coverageCheck", True):
            self._grid_coverage_check()

    def _check_device_store(self, model):
        """The JAX trainer's conditions on a device store, as ValueErrors
        with its messages."""
        if self.doDAGger and self.DAGgerType == "fixedBatch":
            raise ValueError("deviceStore supports no-DAGger, randomEpoch and "
                             "replaceTimeBatch (fixedBatch rolls out per "
                             "batch on host)")
        if self.grid is not None and self.ellDegree is None:
            raise ValueError("grid deviceStore needs ellDegree (the "
                             "recomputed ELL graph width D)")
        if self.grid is None and self.ellDegree is not None:
            raise ValueError("deviceStore recomputes dense reference-scale "
                             "graphs in the train step; ellDegree requires a "
                             "grid dataset (Flocking.large_device)")
        step = ("rollout_step" if self.grid is None
                else "rollout_step_shifted")
        if not hasattr(model.archit, step):
            raise ValueError(f"deviceStore re-rolls and validates through the "
                             f"step interface ({step})")

    # -- graph-trajectory storage (dense numpy or a numpy-leaf EllGso) ------
    @staticmethod
    def _is_ell(S) -> bool:
        return isinstance(S, EllGso)

    @staticmethod
    def _S_copy(S):
        if isinstance(S, EllGso):
            return EllGso(np.copy(np.asarray(S.idx)),
                          np.copy(np.asarray(S.val)))
        return S.copy()

    @staticmethod
    def _S_index(S, idx):
        if isinstance(S, EllGso):
            return EllGso(np.asarray(S.idx)[idx], np.asarray(S.val)[idx])
        return S[idx]

    @staticmethod
    def _S_setitem(S, idx, value):
        if isinstance(S, EllGso):
            S.idx[idx] = value.idx
            S.val[idx] = value.val
        else:
            S[idx] = value

    @staticmethod
    def _S_concat(a, b):
        if isinstance(a, EllGso):
            return EllGso(np.concatenate([a.idx, b.idx], 0),
                          np.concatenate([a.val, b.val], 0))
        return np.concatenate([a, b], 0)

    # -- a step ------------------------------------------------------------
    def _device_S(self, S):
        """A host batch's graphs as the step takes them: an EllGso on the
        device, or the dense (B,T,1,N,N) f32 stack, converted to ELL of
        width ellDegree on the host when it is given."""
        if not self._is_ell(S):
            S5 = S[:, :, None] if S.ndim == 4 else S
            if self.ellDegree is None:
                return torch.as_tensor(S5, dtype=torch.float32,
                                       device=self.device)
            S = ell_from_dense(S5, d_max=self.ellDegree)
        return EllGso(torch.as_tensor(S.idx, device=self.device),
                      torch.as_tensor(S.val, dtype=torch.float32,
                                      device=self.device))

    def _upload(self, x, y, S):
        """A host batch on the device: f32 (x, y) and its graphs."""
        as_dev = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                           device=self.device)
        return as_dev(x), as_dev(y), self._device_S(S)

    def _step_args(self, idx):
        """The device store's (pos, vel) of the batch, or the host store's
        batch uploaded."""
        if self.deviceStore:
            idxd = torch.as_tensor(np.asarray(idx), device=self.device)
            return self.posAll[idxd], self.velAll[idxd]
        return self._upload(self.xAll[idx], self.yAll[idx],
                            self._S_index(self.SAll, idx))

    def _recompute(self, pos, vel):
        """The device store's batch supervision: (x, y, graphs, ok, largest
        in-degree); the dense recompute has no grid and reports ok and no
        in-degree."""
        from graph_neural_networks_torch.data import flocking as fl
        data = self.data
        if self.grid is None:
            lam = ("power" if getattr(data, "rollout_lam_method", "eig")
                   == "power" else "eig")
            x, y, S = fl.recompute_supervision(
                pos, vel, data.commRadius, data.repelDist, data.accelMax, lam)
            return x, y, S[:, :, None], torch.ones((), dtype=torch.bool), None
        return fl.recompute_supervision_grid(
            pos, vel, data.commRadius, data.repelDist, fl.EXPERT_ACCEL_MAX,
            self.ellDegree, self.grid,
            lam_iters=getattr(data, "rollout_lam_iters", 1))

    def _grid_coverage_check(self):
        """Recompute every stored training trajectory once and warn if a
        cell overflowed or an in-degree exceeds ellDegree: the recomputed
        graphs would then be top-D truncations of the dynamics' neighbor
        sums. The in-degree is the window pass's count, which the JAX check
        does not read when no payload rides the table."""
        ok, deg = True, 0
        for i in range(self.posAll.shape[0]):
            *_, ok_i, deg_i = self._recompute(self.posAll[i:i + 1],
                                              self.velAll[i:i + 1])
            ok = ok and bool(ok_i)
            deg = max(deg, int(deg_i))
        self.maxInDegree = deg
        if not ok or deg > self.ellDegree:
            warnings.warn(
                "grid deviceStore: a stored training trajectory overflows "
                "cell_cap or has an in-degree above ellDegree; recomputed "
                "training graphs are truncated inconsistently with the "
                "dynamics: raise ellDegree / cell_cap", RuntimeWarning)

    def _learn(self, x, y, S) -> torch.Tensor:
        """Forward over the batch's graphs, loss, backward, optimizer step;
        returns the loss tensor (not waited for)."""
        model = self.model
        model.optimizer.zero_grad(set_to_none=True)
        loss = model.loss(model.archit.split_forward(x, S)[0].float(), y)
        loss.backward()
        model.optimizer.step()
        if model.scheduler is not None:
            model.scheduler.step()
        return loss

    def train_batch(self, idx):
        if self.deviceStore:
            t0 = time.perf_counter()
            x, y, S, _, _ = self._recompute(*self._step_args(idx))
        elif (self.doDAGger and self.DAGgerType == "fixedBatch"
              and self._step_count > 0):
            x, y = self.xAll[idx], self.yAll[idx]
            S = self._S_index(self.SAll, idx)
            xD, yD, SD = self._fixed_batch_dagger(self.initPosAll[idx],
                                                  self.initVelAll[idx])
            t0 = time.perf_counter()
            x, y, S = self._upload(np.concatenate([x, xD], 0),
                                   np.concatenate([y, yD], 0),
                                   self._S_concat(S, SD))
        else:
            t0 = time.perf_counter()
            x, y, S = self._step_args(idx)
        loss = self._learn(x, y, S).item()   # waits for the step
        self._step_count += 1
        return loss, time.perf_counter() - t0

    def train(self):
        self._step_count = 0
        return super().train()

    def _on_epoch_start(self, epoch):
        if self.doDAGger and epoch > 0 and self.DAGgerType == "randomEpoch":
            self._random_epoch_dagger(epoch)

    def _on_batch_start(self, epoch, batch, idx):
        if self.doDAGger and (epoch > 0 or batch > 0) \
                and self.DAGgerType == "replaceTimeBatch":
            self._replace_time_batch_dagger(epoch)

    # -- the expert and the learner's rollouts ------------------------------
    def _expert_accel(self, pos, vel):
        """The expert's acceleration along visited (B, T, 2, N) host
        trajectories, clipped at the dataset's accelMax (reference
        training.py:1320-1400): on the grid (expert_accel_grid, one window
        pass at the repel radius on the dataset's cell geometry; a
        RuntimeWarning reports a cell overflow) when the dataset rolls on
        it, else all pairs in f64 numpy. Host f64 (B, T, 2, N)."""
        data = self.data
        if self.grid is not None:
            from graph_neural_networks_torch.data.flocking import (
                _parse_env_grid, expert_accel_grid)
            gts, gcc, gcf = _parse_env_grid(self.grid)
            B, T, _, N = pos.shape
            as_dev = lambda a: torch.as_tensor(
                np.asarray(a).reshape(B * T, 2, N), dtype=torch.float32,
                device=self.device)
            a, ok = expert_accel_grid(as_dev(pos), as_dev(vel),
                                      data.commRadius, data.repelDist,
                                      data.accelMax, table_size=gts,
                                      cell_cap=gcc, factor=gcf)
            if not bool(ok):
                warnings.warn("grid cell_cap overflowed during DAGger expert "
                              "relabeling: raise cell_cap/table_size",
                              RuntimeWarning)
            return a.cpu().numpy().astype(np.float64).reshape(B, T, 2, N)
        if getattr(data, "rollout_env_chunk", None):
            raise NotImplementedError(
                "the chunked expert relabel (a dataset with "
                "rollout_env_chunk) is not ported yet (ROADMAP queue 1 item "
                "7.3)")
        from graph_neural_networks_torch.data.flocking import (
            expert_accel_host)
        return expert_accel_host(pos, vel, data.repelDist, data.accelMax)

    def _rollout_policy(self, init_pos, init_vel, chunk: int = 16):
        """The learner's closed-loop rollouts from host initial conditions,
        chunk samples at a time (the last chunk ragged: eager PyTorch needs
        no fixed shape, so it is not padded as the JAX trainer's is), each
        relabeled by the expert: host (states, labels, graphs) for the
        store."""
        data = self.data
        outs = []
        for lo in range(0, init_pos.shape[0], chunk):
            pos, vel, _, states, graphs = data.compute_trajectory(
                init_pos[lo:lo + chunk], init_vel[lo:lo + chunk],
                data.duration, self.model.archit)
            if isinstance(graphs, EllGso):
                graphs = (EllGso(graphs.idx, graphs.val.astype(np.float32))
                          if self._is_ell(self.SAll)
                          else ell_to_dense(graphs)[:, :, 0])
            outs.append((states, self._expert_accel(pos, vel), graphs))
        states = np.concatenate([o[0] for o in outs], 0)
        y = np.concatenate([o[1] for o in outs], 0)
        graphs = outs[0][2]
        for o in outs[1:]:
            graphs = self._S_concat(graphs, o[2])
        return states, y, graphs

    # -- DAGger ------------------------------------------------------------
    def _fixed_batch_dagger(self, init_pos, init_vel):
        return self._rollout_policy(init_pos, init_vel)

    def _device_store_update(self, sel):
        """Re-roll the policy from the initial conditions `sel` (host int
        array) in chunks of at most rolloutChunk samples (a bound on the
        rollout's memory; the last chunk is ragged, as eager PyTorch needs
        no fixed shape) and write the (pos, vel) trajectories into the
        device store. The store is copied first, so the originals stay
        intact."""
        data = self.data
        chunk = self.rolloutChunk
        if self.posAll is self.posOrig:
            self.posAll = self.posOrig.clone()
            self.velAll = self.velOrig.clone()
        for lo in range(0, len(sel), chunk):
            sub = np.asarray(sel[lo:lo + chunk])
            pos, vel = data.rollout_traj_device(
                self.initPosAll[sub], self.initVelAll[sub], data.duration,
                self.model.archit)
            tgt = torch.as_tensor(sub, device=self.device)
            self.posAll[tgt] = pos
            self.velAll[tgt] = vel
            del pos, vel

    def _random_epoch_dagger(self, epoch):
        p = max(self.probExpert ** epoch, 0.5)
        n = self.initPosAll.shape[0]
        use_expert = self.rng.binomial(1, p, n).astype(bool)
        learner_idx = np.flatnonzero(~use_expert)
        if self.deviceStore:
            self.posAll, self.velAll = self.posOrig, self.velOrig
            if len(learner_idx):
                self._device_store_update(learner_idx)
            return
        self.xAll = self.xOrig.copy()
        self.yAll = self.yOrig.copy()
        self.SAll = self._S_copy(self.SOrig)
        if len(learner_idx):
            xs, ys, Ss = self._rollout_policy(self.initPosAll[learner_idx],
                                              self.initVelAll[learner_idx])
            self.xAll[learner_idx] = xs
            self.yAll[learner_idx] = ys
            self._S_setitem(self.SAll, learner_idx, Ss)

    def _replace_time_batch_dagger(self, epoch, nReplace: int = 10):
        n = self.initPosAll.shape[0]
        sel = self.rng.permutation(n)[:min(nReplace, n)]
        if self.deviceStore:
            self._device_store_update(sel)
            return
        xs, ys, Ss = self._rollout_policy(self.initPosAll[sel],
                                          self.initVelAll[sel])
        self.xAll[sel] = xs
        self.yAll[sel] = ys
        self._S_setitem(self.SAll, sel, Ss)

    # -- validation: closed-loop cost --------------------------------------
    def _valid_cost(self) -> float:
        data = self.data
        init_pos = data.getData("initPos", "valid")
        init_vel = data.getData("initVel", "valid")
        if self.deviceStore:
            from graph_neural_networks_torch.data.flocking import (
                evaluate_cost_device)
            _, vel = data.rollout_traj_device(init_pos, init_vel,
                                              data.duration, self.model.archit)
            return float(evaluate_cost_device(vel))
        _, vel, _, _, _ = data.compute_trajectory(
            init_pos, init_vel, data.duration, self.model.archit,
            return_graphs="auto")   # the cost never reads the graphs
        return float(data.evaluate(vel=vel))
