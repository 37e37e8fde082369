"""PointSLAM orchestrator (port of hpslam_tpu/slam.py).

One host loop: every frame is tracked (frames 0-1 take the ground-truth
pose), every ``mapping.every_frame``-th frame and the last one are mapped,
keyframes are registered, checkpoints and the final point cloud are
written, and the trajectory is evaluated (ATE).  ``sync_method`` loose /
free defer mapping by a fixed tracker lag, as the reference does.

Every ``vis_freq``-th tracked and mapped frame renders the rendered-vs-
input panels (``utils.visualizer``; ``save_rendered_image`` also writes the
fine level's colour), logged as ``vis`` events.  ``resume`` continues from
the output's latest checkpoint (``restore_from``).  After the colour
refinement, ``mapping.end_correction`` registers the trajectory tail
against the early map (``tools.end_correction``), logged as an
``end_correction`` event.  Every record of ``metrics.jsonl`` is mirrored
to wandb where ``wandb: True`` and the package imports
(``utils.telemetry``), and the run ends with ``plots/summary.png``.

With ``mesh`` in the config (``--mesh dp2``; ``parallel.mesh``) the
tracker and mapper run their dp-sharded programs; every rank runs this
loop on the same data and seeds and holds the same state, and only rank 0
writes outputs and prints.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .convert import params_from_numpy
from .device import resolve_device
from .mapper import Mapper
from .models import decoder as Dec
from .parallel.mesh import local_device, parse_mesh_spec
from .state import NeuralPointCloud
from .tracker import Tracker
from .utils.datasets import Prefetcher, get_dataset
from .utils.logger import Logger, latest_checkpoint, load_checkpoint
from .utils.telemetry import Telemetry, summarize_run
from .utils.visualizer import Visualizer


class PointSLAM:
    def __init__(self, cfg: dict, args=None, device=None):
        self.cfg = cfg
        if device is None:
            device = getattr(args, "device", None)
        self.device = resolve_device(device)
        # optional device mesh (--mesh dp4 / mesh: "dp4" in YAML): the
        # tracker and mapper shard their ray batches over its dp axis;
        # under torchrun rank r runs on cuda:<LOCAL_RANK>
        self.mesh = None
        if cfg.get("mesh"):
            if self.device.type == "cuda":
                self.device = local_device("cuda")
                torch.cuda.set_device(self.device)
            self.mesh = parse_mesh_spec(cfg["mesh"], self.device.type)
        self.is_main = self.mesh is None or self.mesh.is_main
        self.verbose = cfg.get("verbose", True) and self.is_main
        self.output = cfg["data"]["output"]
        self.ckptsdir = os.path.join(self.output, "ckpts")
        if self.is_main:
            os.makedirs(self.ckptsdir, exist_ok=True)
        if self.verbose and self.mesh is not None:
            print(f"device mesh axes: {self.mesh.shape}", flush=True)
        cam = cfg["cam"]
        self.H, self.W = cam["H"], cam["W"]
        self.fx, self.fy = cam["fx"], cam["fy"]
        self.cx, self.cy = cam["cx"], cam["cy"]
        self.update_cam()
        self.scale = cfg["scale"]
        self.mcfg = Dec.ModelConfig.from_cfg(cfg)
        seed = int(cfg.get("seed", 1219))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params = Dec.init_nicer(gen, self.mcfg, self.device)
        self.load_pretrain()
        self.frame_reader = get_dataset(cfg, scale=self.scale,
                                        device=self.device)
        self.n_img = len(self.frame_reader)
        self.estimate_c2w_list = np.zeros((self.n_img, 4, 4), np.float32)
        self.gt_c2w_list = np.zeros((self.n_img, 4, 4), np.float32)
        self.exposure_feat = 0.01 * np.random.default_rng(seed).standard_normal(
            cfg["model"]["exposure_dim"]).astype(np.float32)
        self.npc = NeuralPointCloud(cfg, self.device)
        self.tracker = Tracker(cfg, self)
        self.mapper = Mapper(cfg, self)
        self.logger = Logger(cfg, self)
        self.tracker_vis = Visualizer(
            cfg["tracking"]["vis_freq"],
            os.path.join(self.output, "tracking_vis"), self,
            self.tracker.rcfg, self.verbose, enabled=self.is_main)
        self.mapper_vis = Visualizer(
            cfg["mapping"]["vis_freq"],
            os.path.join(self.output, "mapping_vis"), self,
            self.mapper.rcfg, self.verbose, enabled=self.is_main)
        self.save_rendered_image = cfg["mapping"].get("save_rendered_image",
                                                      False)
        self.every_frame = cfg["mapping"]["every_frame"]
        sync = cfg.get("sync_method", "strict")
        self._map_lag = {"strict": 0, "loose": self.every_frame,
                         "free": 2 * self.every_frame}.get(sync, 0)
        self._pending_maps: list = []
        self._frame_buf: dict = {}
        self.ckpt_freq = cfg["mapping"]["ckpt_freq"]
        self.metrics_path = (os.path.join(self.output, "metrics.jsonl")
                             if self.is_main else os.devnull)
        self.telemetry = Telemetry(cfg if self.is_main else {}, self.output)

    def update_cam(self):
        cfg = self.cfg
        if "crop_size" in cfg["cam"]:
            ch, cw = cfg["cam"]["crop_size"]
            sx, sy = cw / self.W, ch / self.H
            self.fx *= sx
            self.fy *= sy
            self.cx *= sx
            self.cy *= sy
            self.H, self.W = ch, cw
        e = cfg["cam"].get("crop_edge", 0) or 0
        if e > 0:
            self.H -= 2 * e
            self.W -= 2 * e
            self.cx -= e
            self.cy -= e

    def load_pretrain(self):
        """Converted geometry-decoder weights (.npz from
        tools/convert_pretrained.py) into both geometry decoders."""
        path = self.cfg.get("pretrained_decoders", {}).get("middle_fine")
        if not path or not os.path.exists(path):
            return
        data = np.load(path)
        t = lambda k: torch.as_tensor(data[k], device=self.device)
        for level in ("geo_mid", "geo_fine"):
            core = self.params[level]["core"]
            for i in range(len(core["layers"])):
                core["layers"][i] = {"w": t(f"pts_linears.{i}.w"),
                                     "b": t(f"pts_linears.{i}.b")}
                core["fc_c"][i] = {"w": t(f"fc_c.{i}.w"),
                                   "b": t(f"fc_c.{i}.b")}
            core["out"] = {"w": t("output_linear.w"),
                           "b": t("output_linear.b")}
            if "embedder.B" in data:
                self.params[level]["B"] = t("embedder.B")

    def _log_metrics(self, f, record: dict):
        f.write(json.dumps(record) + "\n")
        f.flush()
        self.telemetry.log(record, step=record.get("idx"))

    def _log_vis(self, mf, what: str, records):
        for rec in records:
            self._log_metrics(mf, {"event": "vis", "what": what, **rec})

    def rng_states(self) -> dict:
        """The state of every random stream the run draws from (the point
        insertion's, the tracker's and the mapper's generators and the
        mapper's numpy generator), for the checkpoint."""
        return {"npc": self.npc.gen.get_state().numpy(),
                "tracker": self.tracker.gen.get_state().numpy(),
                "mapper": self.mapper.gen.get_state().numpy(),
                "mapper_np": self.mapper.rng.bit_generator.state}

    def set_rng_states(self, states: dict):
        for gen, key in ((self.npc.gen, "npc"), (self.tracker.gen, "tracker"),
                         (self.mapper.gen, "mapper")):
            gen.set_state(torch.as_tensor(np.asarray(states[key], np.uint8)))
        self.mapper.rng.bit_generator.state = states["mapper_np"]

    def restore_from(self, path: str) -> int:
        """Resume a live run from a Logger checkpoint (this package's or
        hpslam_tpu's): the point levels, the input cloud, the decoder
        parameters, the exposure latent, the pose lists, the keyframe
        registry (images and device tensors re-read from the reader, as the
        Logger strips them), the mapper's last pose and the random streams'
        states.  A checkpoint without stream states (hpslam_tpu's) resumes
        with the streams as this run seeded them.  Returns the checkpointed
        frame index; run() continues at the next."""
        state = load_checkpoint(path)
        for name, lv in state["levels"].items():
            self.npc.restore_level(name, lv["pos"], lv["normal"], lv["geo"],
                                   lv["col"], int(lv.get("capacity", 0)))
        self.npc.restore_input(state["input_pos"], state["input_rgb"],
                               state.get("input_normal"))
        self.params = params_from_numpy(state["decoder_params"], self.device)
        self.exposure_feat = np.asarray(state["exposure_feat"], np.float32)
        idx = int(state["idx"])
        n = min(len(state["estimate_c2w_list"]), self.n_img)
        self.estimate_c2w_list[:n] = state["estimate_c2w_list"][:n]
        self.gt_c2w_list[:n] = state["gt_c2w_list"][:n]
        m = self.mapper
        m.keyframe_list = [int(i) for i in state["keyframe_list"]]
        m.selected_keyframes = dict(state.get("selected_keyframes") or {})
        m.keyframe_dict = []
        for kf in state["keyframe_dict"]:
            fr = self.frame_reader[int(kf["idx"])]
            _r_add, r_query = self.tracker.prepare_radii(fr.color)
            m.keyframe_dict.append(m.keyframe_entry(
                int(kf["idx"]), fr, np.asarray(kf["est_c2w"], np.float32),
                np.asarray(kf["gt_c2w"], np.float32), r_query,
                kf["exposure_feat"]))
        m.prev_c2w = np.asarray(state.get(
            "prev_c2w", state["estimate_c2w_list"][idx]), np.float32)
        if "rng" in state:
            self.set_rng_states(state["rng"])
        elif self.is_main:
            print(f"{path} holds no random-stream states (an hpslam_tpu "
                  "checkpoint): the resumed run draws from fresh streams",
                  flush=True)
        if self.verbose:
            print(f"Resumed from {path} at frame {idx} (pts "
                  f"{self.npc.pts_num()}, {len(m.keyframe_dict)} keyframes)",
                  flush=True)
        return idx

    def _map_frame(self, mf, idx: int, frame, c2w, color_refine=False):
        t0 = time.perf_counter()
        self.params, self.exposure_feat, info = self.mapper.map(
            idx, frame, self.npc, self.params, self.exposure_feat, c2w,
            color_refine=color_refine)
        if info["updated_c2w"] is not None:     # BA adjusted this pose
            self.estimate_c2w_list[idx] = info["updated_c2w"]
            c2w = info["updated_c2w"]
        dt = time.perf_counter() - t0
        if self.verbose:
            print(f"[map] frame {idx}: +{info['frame_pts_add']} locs, "
                  f"{info['n_joint_iters']} iters, geo "
                  f"{info['geo_loss_last']:.3f}, col "
                  f"{info['color_loss_last']:.3f} ({dt:.2f}s)  pts "
                  f"{self.npc.pts_num()}", flush=True)
        self._log_metrics(mf, {
            "event": "map", "idx": idx, "time_s": dt,
            "pts": self.npc.pts_num(), "geo_loss": info["geo_loss_last"],
            "color_loss": info["color_loss_last"],
            "geo_loss_curve": info["geo_loss_curve"],
            "color_loss_curve": info["color_loss_curve"],
            "iters": info["n_joint_iters"]})
        if not (self.cfg["mapping"]["no_vis_on_first_frame"] and idx == 0):
            self._log_vis(mf, "mapping", self.mapper_vis.vis(
                idx, info["n_joint_iters"] - 1, frame.depth, frame.color, c2w,
                self.npc, self.params, info["r_query"], self.exposure_feat,
                save_rendered_image=self.save_rendered_image))
        self.mapper.maybe_register_keyframe(
            idx, frame, c2w, self.gt_c2w_list[idx], info["r_query"],
            self.exposure_feat, self.n_img)
        return info

    def _save_point_clouds(self):
        if len(self.npc.input_pos()) == 0 or not self.is_main:
            return
        from .utils.ply import write_ply_points
        pos = np.asarray(self.npc.input_pos(), np.float32)
        rgb = np.asarray(self.npc.input_rgb(), np.float32)
        np.save(f"{self.output}/final_point_cloud", np.hstack([pos, rgb]))
        for name, lv in self.npc.levels.items():
            np.save(f"{self.output}/npc_cloud_{name}",
                    lv.pos[:lv.count].cpu().numpy())
        write_ply_points(f"{self.output}/final_point_cloud.ply", pos,
                         rgb / 255.0)

    def run(self):
        """Strict-sync tracking + mapping over the sequence; returns
        (ATE results, summary)."""
        n = self.n_img
        track_times, map_times = [], []
        start = 0
        if self.cfg.get("resume"):
            ck = latest_checkpoint(self.output)
            if ck is not None:
                start = self.restore_from(ck) + 1
            elif self.verbose:
                print("resume requested but no checkpoint found; starting "
                      "fresh", flush=True)
        prefetcher = Prefetcher(self.frame_reader, start=start)
        try:
            with open(self.metrics_path, "a") as mf:
                for idx, frame in enumerate(prefetcher, start=start):
                    self._step(mf, idx, frame, n, track_times, map_times)
                if self.cfg["mapping"]["color_refine"]:
                    frame = self.frame_reader[n - 1]
                    for _ in range(5):
                        self._map_frame(mf, n - 1, frame,
                                        self.estimate_c2w_list[n - 1],
                                        color_refine=True)
                if self.cfg["mapping"].get("end_correction"):
                    # a failure of the native library raises; a gate's
                    # rejection is a normal "not applied"
                    from .tools.end_correction import apply_end_correction
                    self._log_metrics(mf, {"event": "end_correction",
                                           **apply_end_correction(self)})
                from .tools.eval_ate import evaluate_trajectory
                results = evaluate_trajectory(
                    self.gt_c2w_list, self.estimate_c2w_list, n - 1,
                    self.scale, plot=f"{self.output}/eval_ate_aligned.png"
                    if self.is_main else None,
                    use_alignment=True)
                if self.verbose:
                    print("ate_rmse:", results, flush=True)
                self._log_metrics(mf, {"event": "ate", **{
                    k: float(v) for k, v in results.items()}})
                summary = {
                    "track_ms_mean": 1e3 * float(np.mean(track_times))
                    if track_times else 0.0,
                    "map_ms_mean": 1e3 * float(np.mean(map_times))
                    if map_times else 0.0,
                    "n_frames": n}
                self._log_metrics(mf, {"event": "summary", **summary})
            if self.is_main:
                plot = summarize_run(self.output)
                if plot:
                    self.telemetry.log_image("run_summary", plot)
                    if self.verbose:
                        print(f"Run summary plots: {plot}", flush=True)
        finally:
            prefetcher.close()
            self.telemetry.finish()
            if self.mesh is not None:
                self.mesh.close()
        return results, summary

    def _step(self, mf, idx, frame, n, track_times, map_times):
        sync = self.device.type == "cuda"
        self.gt_c2w_list[idx] = frame.c2w
        t0 = time.perf_counter()
        c2w, tinfo, op = self.tracker.track(
            idx, frame, self.npc, self.params, self.exposure_feat,
            self.estimate_c2w_list, frame.c2w)
        if sync:
            torch.cuda.synchronize(self.device)
        ttime = time.perf_counter() - t0
        if op is not None and self.tracker.use_exposure:
            self.exposure_feat = op["expo_feat"].detach().cpu().numpy()
            self.params = dict(self.params)
            self.params["col_mid"] = dict(self.params["col_mid"],
                                          exposure=op["expo_mid"])
            self.params["col_fine"] = dict(self.params["col_fine"],
                                           exposure=op["expo_fine"])
        self.estimate_c2w_list[idx] = c2w
        if idx > 1 and self.verbose and "loss_best" in tinfo:
            print(f"[track] frame {idx}: loss {tinfo['loss_init']:.2f}->"
                  f"{tinfo['loss_best']:.2f} quad_err "
                  f"{tinfo['cam_error_quad']:.4f} pos_err "
                  f"{tinfo['cam_error_pos']:.4f} ({ttime:.2f}s)", flush=True)
        if not tinfo.get("skipped"):
            track_times.append(ttime)
            self._log_metrics(mf, {
                "event": "track", "idx": idx, "time_s": ttime,
                "loss": tinfo.get("loss_best"),
                "loss_curve": tinfo.get("loss_curve"),
                "quad_err": tinfo.get("cam_error_quad"),
                "pos_err": tinfo.get("cam_error_pos")})
            self._log_vis(mf, "tracking", self.tracker_vis.vis(
                idx, self.tracker.iters - 1, frame.depth, frame.color, c2w,
                self.npc, self.params, tinfo["r_query"], self.exposure_feat))
        if idx % self.every_frame == 0:
            self._pending_maps.append(idx)
            self._frame_buf[idx] = frame
        while self._pending_maps and (
                idx - self._pending_maps[0] >= self._map_lag
                or idx == n - 1):
            m = self._pending_maps.pop(0)
            t0 = time.perf_counter()
            self._map_frame(mf, m, self._frame_buf.pop(m),
                            self.estimate_c2w_list[m])
            if sync:
                torch.cuda.synchronize(self.device)
            map_times.append(time.perf_counter() - t0)
        if idx == n - 1 and idx % self.every_frame != 0:
            t0 = time.perf_counter()
            self._map_frame(mf, idx, frame, self.estimate_c2w_list[idx])
            if sync:
                torch.cuda.synchronize(self.device)
            map_times.append(time.perf_counter() - t0)
        if self.is_main and ((idx > 0 and idx % self.ckpt_freq == 0)
                             or idx == n - 1):
            self.logger.log(idx, self.npc, self.params, self.exposure_feat,
                            self.mapper.keyframe_list,
                            self.mapper.keyframe_dict,
                            self.mapper.selected_keyframes,
                            self.estimate_c2w_list, self.gt_c2w_list)
        if idx == n - 1:
            self._save_point_clouds()
