"""The 1-D block-row partition axis as a torch.distributed process group —
counterpart of ``bmsparse_tpu/parallel/mesh.py``.

A `Mesh` is a thin handle on an initialised process group: this process's
rank, the world size and the device its shard lives on. Ranks are started
by `parallel/launch.py` (or any launcher that calls
`init_process_group`); the group's backend follows the device: NCCL for a
CUDA device, gloo only where the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


# the fused all-gather's newer name; both take (output, input, group)
_all_gather_single = getattr(dist, "all_gather_single",
                             None) or dist.all_gather_into_tensor


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group seen from one rank, with the exchanges of the
    multi-device path (the JAX package's collectives over its mesh axis:
    all_gather(tiled=True), all_to_all, psum, ppermute)."""

    group: object          # a torch.distributed ProcessGroup
    rank: int
    size: int
    device: torch.device

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x concatenated along dim 0, in rank order."""
        x = x.contiguous()
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather_single(out, x, group=self.group)
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x is (size, ...): slice j goes to rank j; slice r of the result
        came from rank r (equal splits)."""
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the ranks (a new tensor)."""
        out = x.clone()
        dist.all_reduce(out, group=self.group)
        return out

    def halo(self, to_right: torch.Tensor | None,
             to_left: torch.Tensor | None):
        """Neighbour exchange on the open chain of ranks: send to_right to
        rank + 1 and to_left to rank - 1; returns (from_left, from_right),
        zeros where the neighbour does not exist (rank 0's left, the last
        rank's right), None where nothing is sent that way."""
        ops = []
        recv = []
        for sent, peer in ((to_right, self.rank + 1), (to_left,
                                                       self.rank - 1)):
            if sent is None:
                recv.append(None)
                continue
            buf = torch.zeros_like(sent)
            # the piece a rank receives from one side is the one its peer
            # on the other side sends, of the same size
            src = 2 * self.rank - peer
            if 0 <= peer < self.size:
                ops.append(dist.P2POp(dist.isend, sent.contiguous(), peer,
                                      self.group))
            if 0 <= src < self.size:
                ops.append(dist.P2POp(dist.irecv, buf, src, self.group))
            recv.append(buf)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return recv[0], recv[1]


def make_mesh(n_devices: int, device="cuda", group=None) -> Mesh:
    """The mesh of an initialised process group of n_devices ranks (the
    default group unless `group` is given). Raises when there is no group,
    when its size is not n_devices or when its backend does not serve
    `device`; it never falls back to one rank."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: start the ranks with "
            "bmsparse_tpu_torch.parallel.launch.run_ranks or call "
            "init_process_group first")
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    if size != n_devices:
        raise ValueError(f"need {n_devices} ranks, the group has {size}")
    device = torch.device(device)
    want = BACKENDS.get(device.type)
    backend = dist.get_backend(group)
    if want is None or backend != want:
        raise ValueError(f"a {device.type} mesh needs the {want} backend, "
                         f"the group runs {backend}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, dist.get_rank(group), size, device)
