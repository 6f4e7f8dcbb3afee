"""Loop `train_iterations`: a training run. Set-up writes the mix's
dataset from the seed (`harness/inputs.py::write_srn`, at the
configuration's scene count, views, image size and focal); the
configuration's `train` then drives the program's own loop over it: the
window holds the iterations that start while fewer than `seconds` have
passed, at least `min_iters`, after `setup_iters` set-up ones."""
import os

from portbench.harness.inputs import write_srn

__all__ = ["Loop"]


class Loop:
    def __init__(self, system, traffic, seed, workdir, device):
        self.system, self.traffic = system, traffic
        self.seed, self.workdir, self.device = seed, workdir, device

    def run(self, seconds, hooks, begin, end):
        data = dict(self.traffic["dataset"])
        c = self.system.cfg
        data.update(scenes=c["scenes"], views=c["views"],
                    size=c["image_size"], focal=c["focal"])
        root = os.path.join(self.workdir, "srn")
        captions = write_srn(root, data, self.seed)
        return self.system.train(root, captions, self.traffic, seconds,
                                 hooks, begin, end, self.workdir)
