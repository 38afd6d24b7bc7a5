"""Inference demo CLI for images, videos and GIFs (counterpart of
dino_pose_tpu/cli/demo.py).

    python -m dino_pose_tpu_torch.cli.demo --input FILE [--model NAME_OR_PTH] [--output FILE]
        [--plot_mode {2d,3d,combined}] [--keypoint_label [BOOL]] [--show_info]
        [--max_frames N] [--fps F] [--batch_size N]

The JAX CLI's flags. Prediction is ``serve.make_predictor`` on the card
(tests pass ``device="cpu"``). The plots draw from the heatmaps and z it
returns, which ``viz`` decodes into the original image's size; the
predictor's own keypoints are in the pixels of the model's crop and are not
drawn. Video frames go through the forward in chunks of ``--batch_size``,
the last chunk padded with zero frames. matplotlib, imageio and cv2 are
imported only where a plot is drawn or a video read or written.
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

VIDEO_EXTENSIONS = {".mp4", ".avi", ".mov", ".mkv", ".wmv", ".flv", ".webm", ".m4v"}
GIF_EXTENSIONS = {".gif"}


def _str2bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes", "y"):
        return True
    if v.lower() in ("false", "0", "no", "n", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def is_video_file(file_path) -> bool:
    return pathlib.Path(file_path).suffix.lower() in VIDEO_EXTENSIONS | GIF_EXTENSIONS


def extract_frames(video_path, max_frames=None):
    """Frames of a video/GIF as PIL images."""
    from PIL import Image

    frames = []
    if str(video_path).lower().endswith(".gif"):
        import imageio

        for i, frame in enumerate(imageio.mimread(video_path)):
            if max_frames and i >= max_frames:
                break
            frames.append(Image.fromarray(frame).convert("RGB"))
        return frames

    import cv2

    cap = cv2.VideoCapture(str(video_path))
    while True:
        ret, frame = cap.read()
        if not ret or (max_frames and len(frames) >= max_frames):
            break
        frames.append(Image.fromarray(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)))
    cap.release()
    return frames


def get_video_fps(video_path) -> float:
    if str(video_path).lower().endswith(".gif"):
        return 10.0
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return fps if fps > 0 else 25.0


def render_figure(image, heatmaps, z, plot_mode, keypoint_label):
    from dino_pose_tpu_torch import viz

    if plot_mode == "3d":
        return viz.plot_3d_keypoints(image, heatmaps, z, keypoint_label=keypoint_label)
    if plot_mode == "combined":
        return viz.plot_keypoints_combined(image, heatmaps, z, keypoint_label=keypoint_label)
    return viz.plot_keypoints(image, heatmaps, keypoint_label=keypoint_label)


def draw_image(image, heatmaps, z, args) -> None:
    """One image's plot from its (K, h, w) heatmaps and (K,) z, saved to
    ``args.output`` or shown."""
    import matplotlib

    if args.output:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = render_figure(image, heatmaps, z, args.plot_mode, args.keypoint_label)
    if args.output:
        fig.savefig(args.output, bbox_inches="tight", dpi=100)
        print(f"Visualization saved to {args.output}")
    else:
        plt.show()
    plt.close(fig)


def process_single_image(image, predict, args):
    _, z, heatmaps = predict([image])
    draw_image(image, heatmaps[0], z[0], args)


def predict_chunks(frames, predict, preprocessor, batch_size):
    """Yield ``(chunk, heatmaps, z)`` for each run of ``batch_size`` frames:
    one forward of ``batch_size`` images a chunk, the last padded with zero
    frames, the padding's outputs dropped."""
    for start in range(0, len(frames), batch_size):
        chunk = frames[start : start + batch_size]
        pixels = preprocessor(chunk)["pixel_values"]
        _, z, heatmaps = predict(_pad_to(pixels, batch_size))
        yield chunk, heatmaps[: len(chunk)], z[: len(chunk)]


def process_video(frames, predict, preprocessor, args, input_fps):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from dino_pose_tpu_torch.viz import fig_to_array

    # Video always renders in 2d, as the reference does.
    plot_mode = "2d"
    out_frames = []
    for chunk, heatmaps, z in predict_chunks(frames, predict, preprocessor, args.batch_size):
        for j, frame in enumerate(chunk):
            fig = render_figure(frame, heatmaps[j], z[j], plot_mode, args.keypoint_label)
            out_frames.append(fig_to_array(fig))
            plt.close(fig)
        print(f"Processed {len(out_frames)}/{len(frames)} frames")

    if not out_frames:
        raise SystemExit(
            f"Could not read any frames from {args.input} — unreadable, "
            "corrupt, or missing-codec video (cv2.VideoCapture returned "
            "no frames)."
        )
    # Unify frame sizes (matplotlib can produce off-by-a-few differences).
    h = min(f.shape[0] for f in out_frames)
    w = min(f.shape[1] for f in out_frames)
    out_frames = [f[:h, :w] for f in out_frames]
    fps = args.fps or input_fps
    save_video(out_frames, args.output, fps)


def _pad_to(pixels: np.ndarray, batch: int) -> np.ndarray:
    if len(pixels) == batch:
        return pixels
    pad = np.zeros((batch - len(pixels), *pixels.shape[1:]), pixels.dtype)
    return np.concatenate([pixels, pad])


def save_video(frames, output_path, fps):
    output_path = str(output_path)
    if output_path.lower().endswith(".gif"):
        import imageio

        imageio.mimsave(output_path, frames, duration=1000.0 / max(fps, 1e-6))
    else:
        import cv2

        h, w = frames[0].shape[:2]
        writer = cv2.VideoWriter(
            output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
        )
        for f in frames:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        writer.release()
    print(f"Video saved to {output_path}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="DINOv2 Keypoint Detection Demo - Supports images, videos, and GIFs"
    )
    parser.add_argument("--input", type=str, required=False,
                        help="Path to input image, video, or gif")
    parser.add_argument("--model", type=str, default="facebook/dinov2-base",
                        help="Path to model checkpoint or DINOv2 model name")
    parser.add_argument("--num_keypoints", type=int, default=24,
                        help="Number of keypoints to detect (only used for pretrained models)")
    parser.add_argument("--output", type=str, default=None,
                        help="Path to save visualization output (image/video/gif)")
    parser.add_argument("--threshold", type=float, default=0.5,
                        help="Confidence threshold for keypoint visualization")
    # A real boolean parser that accepts the reference's spellings (its
    # type=bool parses the string 'False' as True).
    parser.add_argument("--keypoint_label", type=_str2bool, nargs="?",
                        const=True, default=False,
                        help="Whether to show keypoint labels in visualization")
    parser.add_argument("--show_info", action="store_true",
                        help="Show model information before inference")
    parser.add_argument("--plot_mode", type=str, choices=["2d", "3d", "combined"],
                        default="combined",
                        help="Visualization mode: 2d, 3d, or combined")
    parser.add_argument("--max_frames", type=int, default=None,
                        help="Maximum number of frames to process (for videos/gifs)")
    parser.add_argument("--fps", type=float, default=None,
                        help="Output FPS for video/gif (defaults to input FPS)")
    parser.add_argument("--batch_size", type=int, default=8,
                        help="Frames per jitted forward for video inference")
    parser.add_argument("--image", type=str, default=None,
                        help="(Deprecated) Use --input instead")
    return parser


def main(argv=None, *, device=None) -> None:
    from dino_pose_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    args = build_parser().parse_args(argv)
    if args.image and not args.input:
        args.input = args.image
        print("Warning: --image is deprecated, use --input instead")
    if not args.input:
        raise SystemExit("--input is required")

    from dino_pose_tpu_torch.core.device import resolve_device
    from dino_pose_tpu_torch.data.preprocess import create_preprocessor
    from dino_pose_tpu_torch.io.checkpoint import get_model_info, load_model_smart
    from dino_pose_tpu_torch.serve import make_predictor

    dev = resolve_device(device)
    if args.show_info and args.model.endswith(".pth"):
        info = get_model_info(args.model)
        print("Model info:")
        for k, v in info.items():
            print(f"  {k}: {v}")

    model = load_model_smart(args.model, device=dev)
    predict = make_predictor(model, dev)

    if is_video_file(args.input):
        frames = extract_frames(args.input, args.max_frames)
        print(f"Extracted {len(frames)} frames")
        if not args.output:
            raise SystemExit("--output is required for video/gif inputs")
        preprocessor = create_preprocessor(model.model_name)
        process_video(frames, predict, preprocessor, args, get_video_fps(args.input))
    else:
        from PIL import Image

        image = Image.open(args.input).convert("RGB")
        process_single_image(image, predict, args)


if __name__ == "__main__":
    main()
