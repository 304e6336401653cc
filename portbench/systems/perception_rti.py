"""BASELINE config 3 as the system under test: uint16 depth frames through
the program's preprocessing (``perception.clip_distance``,
``perception.depth2range``) and its ResNet-VAE encoder (``nn.vae.Encoder``
with the trained weights), the latents into the step's parameters, then the
same steady RTI step as config 4 (``systems/rti_step.py``).

The harness renders the frames itself (``portbench/scenes.py``) and reads
the encoder's raw weight file with its own reader; the reference
(``reference/encoder.py`` then ``reference/rti_step.py``) works the
latents and the step out again from the same frames.
"""

from __future__ import annotations

import time

import torch

from portbench import scenes
from portbench.reference.encoder import EncoderRef, preprocess
from portbench.reference.msgpack_tree import msgpack_restore
from portbench.systems import rti_step


class Encoder:
    """The program's preprocessing and encoder on ``device``."""

    def __init__(self, conf: dict, tree: dict, device, tf32: bool = False):
        """``tf32``: the encoder's convolutions in TF32 (the control of the
        comparison; the configuration states float32 with TF32 off)."""
        from sdf_nmpc_tpu_torch.nn.vae import Encoder as Net
        from sdf_nmpc_tpu_torch.nn.weights import encoder_from_jax

        pc = conf["perception"]
        self.pc = pc
        net = Net(size_latent=pc["size_latent"], batchnorm=pc["batchnorm"])
        net.load_state_dict(encoder_from_jax(tree))
        self.net = net.to(device).eval()
        self.tf32 = tf32

    @torch.no_grad()
    def __call__(self, frames):
        from sdf_nmpc_tpu_torch.perception import clip_distance, depth2range

        pc = self.pc
        x = clip_distance(frames.to(torch.float32), pc["dmax"], pc["mm_resolution"])
        x = depth2range(x, pc["hfov"], pc["vfov"])
        if not self.tf32:
            return self.net(x)
        keep = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            return self.net(x)
        finally:
            torch.backends.cudnn.allow_tf32 = keep


class Cell(rti_step.Cell):
    """A tick: one frame set (``traffic['scenarios']`` frames, pinned on the
    host, ``traffic['frame_sets']`` sets in turn) copied to the card,
    preprocessed and encoded, the latents into p, one steady step, u0 to the
    host; the plant advances as in config 4's cells."""

    def setup(self):
        self.marks = {"entered": time.perf_counter()}
        pc, tr = self.conf["perception"], self.traffic
        if "encoder" not in self.cache:
            self.cache["encoder"] = msgpack_restore((self.root / pc["weights"]).read_bytes())
        self.enc_tree = self.cache["encoder"]
        over = dict(self.overrides or {})
        tf32 = bool(over.pop("encoder_tf32", False))
        self.overrides = over or None
        self.encoder = Encoder(self.conf, self.enc_tree, self.device, tf32)
        if self.wraps("encoder"):
            self.encoder = self.wrap(self.encoder)
        n_sets = int(tr["frame_sets"])
        drawn = scenes.draw_scenes(n_sets * self.B, int(tr["spheres"]), [self.seed, 3])
        frames = scenes.render(drawn, pc["shape"][-2:], pc["hfov"], pc["vfov"], pc["dmax"],
                               self.device)
        pin = self.device.type == "cuda"
        self.frames = [f.cpu().pin_memory() if pin else f.cpu()
                       for f in frames.reshape(n_sets, self.B, *frames.shape[1:])]
        self.k = 0
        self.enc_events = []
        self.marks["frames"] = time.perf_counter()
        super().setup()

    def start_window(self):
        super().start_window()
        self.enc_events = []

    def first_latents(self):
        return self.encoder(self.frames[0].to(self.device))

    def _set_latents(self, z):
        i = self.conf["params"]["latent"]
        self.x.p[:, :, i:] = z[:, None, :]

    def encode_next(self):
        """The tick's perception: the next frame set to the card, through
        the program's preprocessing and encoder, its latents into p."""
        fr = self.frames[self.k % len(self.frames)].to(self.device, non_blocking=True)
        timed = self.device.type == "cuda"
        if timed:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        z = self.encoder(fr)
        if timed:
            e1.record()
            self.enc_events.append((e0, e1))
        self._set_latents(z)
        self.last_z = z
        self.k += 1

    def tick(self, window):
        self.encode_next()
        super().tick(window)

    def spans(self) -> dict:
        return {"encode_ms": [a.elapsed_time(b) for a, b in self.enc_events]}

    # -- set-up hooks of the parent --
    def cold_inputs(self):
        """The cold step's latents: frame set 0 through the program."""
        self._set_latents(self.first_latents())

    def cold_rows(self) -> dict:
        rows = super().cold_rows()
        rows["p"][:, :, self.conf["params"]["latent"]:] = self.cold_z[:, None, :]
        return rows

    def check_step(self):
        """One more tick through the window's calls; keeps the sampled rows'
        frames, the program's latents, the step's inputs, input state and
        output."""
        rows = torch.as_tensor(self.idx, device=self.device)
        self.check_frames = self.frames[self.k % len(self.frames)][self.idx]
        X_in, U_in = self.res.state.X[rows].cpu(), self.res.state.U[rows].cpu()
        self.encode_next()
        self.check_z = self.last_z[rows].cpu()
        self.last_inp = {k: getattr(self.x, k)[rows].double().cpu().numpy()
                         for k in self.x._fields}
        self.unit()
        res = self.res
        self.u0_host = res.u0.to("cpu")
        self.last = (X_in, U_in, res.state.X[rows].cpu(), res.state.U[rows].cpu(),
                     (res.status[rows] == 0).cpu())
        self.res = self.x = None

    def numbers(self, ref_device) -> dict:
        pc = self.conf["perception"]
        enc = EncoderRef(self.enc_tree, ref_device)
        dmax_mm = pc["dmax"] / pc["mm_resolution"] * 1000

        def ref_latents(frames):
            out = []
            with torch.no_grad():
                for i in range(0, len(frames), 32):
                    x = preprocess(frames[i:i + 32].to(ref_device), dmax_mm, pc["hfov"],
                                   pc["vfov"])
                    out.append(enc(x).cpu())
            return torch.cat(out)

        z_ref = ref_latents(self.check_frames)
        scale = 1.0 + z_ref.abs().amax(-1)
        z_gap = ((self.check_z.double() - z_ref).abs().amax(-1) / scale)
        i = self.conf["params"]["latent"]
        # the reference's steps read the reference's latents
        self.last_inp["p"][:, :, i:] = z_ref.numpy()[:, None, :]
        self.cold_z = ref_latents(self.frames[0][self.idx]).numpy()
        out = super().numbers(ref_device)
        out.update(z_med=float(torch.quantile(z_gap, 0.5)), z_max=float(z_gap.max()))
        return out
