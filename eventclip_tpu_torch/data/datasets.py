"""Event-camera datasets: N-Caltech101, N-Cars, N-ImageNet, N-ImageNet-Mini.

Port of eventclip_tpu/data/datasets.py. Behavioral contracts (reference):
- folder-per-class event trees, classes = sorted(listdir)  datasets/caltech.py:38
- CoOp class renames (NEW_CNAMES)                          datasets/caltech.py:16-23
- few-shot sampling, seed 0, persisted splits              datasets/caltech.py:85-138
- per-item load -> center -> augment -> retry-on-empty     datasets/caltech.py:163-191
- N-Cars stats / N-ImageNet npz parsing & robustness
  subsets / Mini 100-class filter                          datasets/cars.py,
                                                           datasets/imagenet.py,
                                                           datasets/imagenet_mini.py

These classes only do O(n) host work on raw event streams (load, center,
event-space augment); rasterization and all image-space processing run on
the card (ops.rasterize.rasterize_for_clip).

Few-shot split assets: the reference's pickled splits, carried as json.gz
files under this package's own assets/splits/<ClassName>/
<K>shot-repeat=<bool>.json.gz (a relative event path -> its integer
label), byte-equal to the JAX package's copies, so published few-shot
protocols reproduce exactly. N-ImageNet archives decode in one native
pass when the host-ops library loads (eventclip_tpu_torch/native), else on
the bit-identical numpy path.
"""

from __future__ import annotations

import gzip
import json
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import native
from .host_ops import prepare_stream

ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")

# class renames from CoOp (reference datasets/caltech.py:16-23)
CALTECH_NEW_CNAMES = {
    "airplanes": "airplane",
    "Faces": "face",
    "Faces_easy": "face",
    "Motorbikes": "motorbike",
    "Leopards": "leopard",
    "BACKGROUND_Google": "background",
}

CARS_NEW_CNAMES = {
    "cars": "car",
    "background": "background",
}


def real_path(path: str) -> str:
    # realpath, not readlink-in-a-loop: relative symlink targets resolve
    # against the link's parent directory, not the process CWD
    return os.path.realpath(path)


def load_split_asset(cls_name: str, num_shots: int, repeat: bool) -> Optional[Dict[str, int]]:
    """Load a shipped few-shot split: {relative event path: label}."""
    fn = os.path.join(
        ASSETS_DIR, "splits", cls_name,
        f"{num_shots}shot-repeat={repeat}.json.gz",
    )
    if not os.path.exists(fn):
        return None
    with gzip.open(fn, "rt") as f:
        return json.load(f)


def imagenet_folder2name(path: Optional[str] = None) -> Dict[str, str]:
    """wnid -> CLIP class name map (assets/CLIP-IN_ClassNames.txt, 1000 rows)."""
    path = path or os.path.join(ASSETS_DIR, "CLIP-IN_ClassNames.txt")
    with open(path) as f:
        lines = [ln.strip() for ln in f.readlines()[:1000]]
    return {ln.split(" ")[0]: " ".join(ln.split(" ")[1:]) for ln in lines}


class NCaltech101:
    """Base event dataset (N-Caltech101 semantics; others subclass)."""

    # data stats (reference datasets/caltech.py:52-58)
    resolution: Tuple[int, int] = (180, 240)
    max_t: float = 0.325
    max_n: int = 225000
    max_shift: int = 20
    flip_time: bool = False
    new_cnames: Optional[Dict[str, str]] = CALTECH_NEW_CNAMES

    def __init__(
        self,
        root: str,
        augmentation: bool = False,
        num_shots: Optional[int] = None,
        repeat: bool = True,
        seed: int = 0,
    ):
        root = real_path(root)
        self.root = root
        self.is_pseudo = "pseudo" in root  # caltech.py:47
        self.augmentation = augmentation
        self.num_shots = num_shots
        self.few_shot = num_shots is not None and num_shots > 0
        if self.few_shot:
            assert "train" in root.lower(), (
                "few-shot subsampling is restricted to the training split"
            )
        self.repeat = repeat
        self._seed = seed
        self._epoch = 0

        self.classes = self._list_classes()
        self.labeled_files, self.labels = self._get_sample_idx()
        self._rename_classes()

    # -- construction helpers ------------------------------------------------

    def _list_classes(self) -> List[str]:
        return sorted(os.listdir(self.root))

    def _rename_classes(self) -> None:
        if not self.new_cnames:
            return
        self.classes = [self.new_cnames.get(c, c) for c in self.classes]

    def _split_name(self) -> str:
        return type(self).__name__

    def _get_sample_idx(self):
        if self.few_shot and not self.is_pseudo:
            split = load_split_asset(
                self._split_name(), self.num_shots, self.repeat
            )
            if split is not None:
                files = [self._resolve_split_path(p) for p in split.keys()]
                # the shipped split only applies to the real dataset tree;
                # fall back to seeded sampling for any other root
                if all(os.path.exists(f) for f in files[:: max(len(files) // 16, 1)]) \
                        and os.path.exists(files[0]):
                    return np.array(files), np.array(list(split.values()))

        files: List[str] = []
        labels: List[int] = []
        # fixed seed: the sampled split is data-deterministic (caltech.py:103)
        random.seed(0)
        for i, c in enumerate(self.classes):
            cls_dir = os.path.join(self.root, c)
            cls_files = [
                real_path(os.path.join(cls_dir, f))
                for f in sorted(os.listdir(cls_dir))
            ]
            if not cls_files:
                continue
            if self.few_shot:
                if self.num_shots <= len(cls_files):
                    picked = random.sample(cls_files, k=self.num_shots)
                elif self.repeat:
                    picked = random.choices(cls_files, k=self.num_shots)
                else:
                    picked = cls_files
            else:
                picked = cls_files
            files += picked
            labels += [i] * len(picked)
        return np.array(files), np.array(labels)

    def _resolve_split_path(self, rel: str) -> str:
        """Map a shipped split path ('data/<DS>/<split>/<cls>/<f>') to root."""
        cls, fn = rel.replace("\\", "/").split("/")[-2:]
        return os.path.join(self.root, cls, fn)

    # -- item access ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self.labeled_files)

    def set_epoch(self, epoch: int) -> None:
        """Varies per-item augmentation draws across epochs (loaders call
        this; per-item generators keep multi-threaded loading race-free)."""
        self._epoch = int(epoch)

    def _item_rng(self, idx: int) -> np.random.Generator:
        # fresh per-call generator: np.random.Generator is NOT thread-safe,
        # and the PrefetchLoader reads items from several threads
        return np.random.default_rng((self._seed, self._epoch, idx))

    @staticmethod
    def _load_events(event_path: str) -> np.ndarray:
        return np.load(event_path).astype(np.float32)

    def __getitem__(self, idx: int):
        rng = self._item_rng(idx)
        path = str(self.labeled_files[idx])
        label = int(self.labels[idx])
        events = self._load_events(path)
        # centering keeps N-Caltech's sub-box events inside the center crop
        # (caltech.py:172-175); augmentations per _augment contracts
        # (utils.py:4-35)
        events = prepare_stream(
            events, self.resolution, rng=rng, augment=self.augmentation,
            flip_time=self.flip_time, max_shift=self.max_shift,
        )
        if events.shape[0] == 0:
            # augmentation can shift everything out of frame; resample
            return self[int(rng.integers(0, len(self)))]
        return {"events": events, "label": label, "data_idx": idx}


class NCars(NCaltech101):
    """N-Cars: 2 classes {car, background} (reference datasets/cars.py)."""

    resolution = (100, 120)
    max_t = 0.1
    max_n = 12500
    max_shift = 10
    new_cnames = CARS_NEW_CNAMES

    def __init__(self, root, augmentation=False, num_shots=None, seed=0):
        super().__init__(
            root, augmentation=augmentation, num_shots=num_shots,
            repeat=False, seed=seed,
        )


def _read_npz_member(path: str, name: str) -> Optional[np.ndarray]:
    """Read one STORED (uncompressed) member of an npz straight from the
    file region, skipping zipfile's per-chunk Python loop and CRC pass
    (~13x on N-ImageNet records; the data is re-validated downstream by
    shape/dtype checks and, in training, by the loss). Returns None for
    compressed/odd archives — caller falls back to np.load.
    EVENTCLIP_NO_FAST_NPZ=1 forces the np.load path."""
    import struct
    import zipfile

    if os.environ.get("EVENTCLIP_NO_FAST_NPZ", "") == "1":
        return None
    try:
        with open(path, "rb") as f:
            with zipfile.ZipFile(f) as z:
                info = z.getinfo(name)
                if info.compress_type != zipfile.ZIP_STORED:
                    return None
            # one file handle: past the zip directory walk, read the member
            # region directly
            f.seek(info.header_offset)
            hdr = f.read(30)
            if len(hdr) != 30 or hdr[:4] != b"PK\x03\x04":
                return None
            nlen, elen = struct.unpack("<HH", hdr[26:30])
            f.seek(info.header_offset + 30 + nlen + elen)
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_2_0(f)
            else:
                return None
            if fortran or dtype.hasobject:
                return None
            count = int(np.prod(shape)) * dtype.itemsize
            data = f.read(count)
            if len(data) != count:
                return None
            return np.frombuffer(data, dtype=dtype).reshape(shape)
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        return None


def load_event_npz(event_path: str) -> np.ndarray:
    """N-ImageNet structured npz -> [N, 4] float32 (imagenet.py:8-27).

    Column-wise decode straight into the float32 layout the pipeline
    consumes, bit-identical to the reference chain (stack -> float64 ->
    µs/1e6 -> ±1 remap -> float32 downcast; t runs through the same
    float64 divide before the downcast). One fused native pass
    (native.decode_struct) when the library is loadable."""
    event = _read_npz_member(event_path, "event_data.npy")
    if event is None:
        event = np.load(event_path)["event_data"]
    if len(event) == 0:
        # keep corrupt archives loud on both routes: the native pass would
        # silently return a (0, 4) array
        raise ValueError(f"empty event_data in {event_path}")
    dec = native.decode_struct(event)
    if dec is not None:
        return dec
    out = np.empty((len(event), 4), np.float32)
    out[:, 0] = event["x"]
    out[:, 1] = event["y"]
    out[:, 2] = event["t"].astype(np.float64) / 1e6  # int µs -> s
    p = event["p"].astype(np.uint8).astype(np.float32)
    if p.min() >= -0.5:  # 0/1 polarity -> -1/+1
        np.copyto(p, -1.0, where=p <= 0.5)
    out[:, 3] = p
    return out


class NImageNet(NCaltech101):
    """N-ImageNet (reference datasets/imagenet.py)."""

    resolution = (480, 640)
    max_t = 0.055
    max_n = 135000
    max_shift = 20
    flip_time = True
    new_cnames = None

    def _rename_classes(self) -> None:
        self.folder2name = imagenet_folder2name()
        self.name2folder = {v: k for k, v in self.folder2name.items()}
        self.classes = [self.folder2name[c] for c in self.classes]

    @staticmethod
    def _load_events(event_path: str) -> np.ndarray:
        return load_event_npz(event_path)


# N-ImageNet (Mini) 100-class subset, from arXiv 2308.09383 (reference
# datasets/imagenet_mini.py:8-32); names follow CLIP's ImageNet prompts
MINI_NAMES = [
    "hamster", "academic gown", "airship", "jackfruit", "barbershop",
    "cocktail shaker", "Komodo dragon", "sunglasses", "grey fox", "cello",
    "comic book", "goldfish", "Bloodhound", "porcupine", "jaguar", "kingsnake",
    "altar", "water buffalo", "chiton", "scarf", "storage chest", "tool kit",
    "sea anemone", "Border Terrier", "menu", "picket fence", "forklift",
    "yellow lady's slipper", "chameleon", "dragonfly", "Pomeranian",
    "European garden spider", "Airedale Terrier", "frilled-necked lizard",
    "black stork", "valley", "radio telescope", "leopard", "crossword",
    "Australian Terrier", "Shih Tzu", "husky", "can opener", "artichoke",
    "assault rifle", "fountain pen", "harvestman", "parallel bars",
    "harmonica", "half-track", "snoek fish", "pencil sharpener", "submarine",
    "muzzle", "eastern diamondback rattlesnake", "Miniature Schnauzer",
    "missile", "Komondor", "grand piano", "website", "king penguin", "canoe",
    "red-breasted merganser", "trolleybus", "quail", "poke bonnet",
    "King Charles Spaniel", "race car", "Malinois", "solar thermal collector",
    "slug", "bucket", "dung beetle", "Asian elephant", "window screen",
    "Flat-Coated Retriever", "steel drum", "snowplow", "handkerchief",
    "tailed frog", "church", "Chesapeake Bay Retriever", "Christmas stocking",
    "hatchet", "hair clip", "vulture", "sidewinder rattlesnake",
    "oscilloscope", "worm snake", "eel", "wok", "planetarium",
    "Old English Sheepdog", "platypus", "Pembroke Welsh Corgi",
    "alligator lizard", "consomme", "African rock python", "hot tub",
    "Tibetan Mastiff",
]


class NImageNetMini(NImageNet):
    """100-class N-ImageNet subset (reference datasets/imagenet_mini.py).

    Unlike the others, the class list comes from the name table (wnids whose
    CLIP name is in MINI_NAMES, in table order) rather than listdir, so a
    full 1000-class tree can back a Mini run (imagenet_mini.py:76-101).
    """

    def __init__(self, root, augmentation=False, num_shots=None, repeat=True,
                 seed=0):
        super(NImageNet, self).__init__(
            root, augmentation=augmentation, num_shots=num_shots,
            repeat=repeat, seed=seed,
        )

    def _list_classes(self) -> List[str]:
        self.folder2name = {
            k: v for k, v in imagenet_folder2name().items() if v in MINI_NAMES
        }
        assert len(self.folder2name) == 100 == len(MINI_NAMES)
        self.name2folder = {v: k for k, v in self.folder2name.items()}
        return list(self.folder2name.keys())

    def _rename_classes(self) -> None:
        self.classes = [self.folder2name[c] for c in self.classes]
        assert len(self.classes) == 100


# ---------------------------------------------------------------------------
# dataset constructors (directory layouts of the reference build_* functions)
# ---------------------------------------------------------------------------

# N-ImageNet robustness subsets keyed 1-9 (reference imagenet.py:89-99)
NIN_VAL_SUBSETS = {
    1: "val_mode_1",
    2: "val_mode_5",
    3: "val_mode_6",
    4: "val_mode_7",
    5: "val_mode_3",
    6: "val_brightness_4",
    7: "val_brightness_5",
    8: "val_brightness_6",
    9: "val_brightness_7",
}


def build_n_caltech_dataset(params, val_only=False, gen_data=False):
    val = NCaltech101(os.path.join(params.data_root, "testing"))
    if val_only:
        assert not gen_data
        return val
    if gen_data:
        return NCaltech101(os.path.join(params.data_root, "training"))
    train = NCaltech101(
        os.path.join(params.data_root, "training"),
        augmentation=True,
        num_shots=params.get("num_shots", None),
        repeat=params.get("repeat_data", True),
    )
    return train, val


def build_n_cars_dataset(params, val_only=False, gen_data=False):
    val = NCars(os.path.join(params.data_root, "test"))
    if val_only:
        assert not gen_data
        return val
    if gen_data:
        return NCars(os.path.join(params.data_root, "train"))
    train = NCars(
        os.path.join(params.data_root, "train"),
        augmentation=True,
        num_shots=params.get("num_shots", None),
    )
    return train, val


def build_n_imagenet_dataset(params, val_only=False, gen_data=False, subset=-1):
    if subset > 0:
        val_root = os.path.join(
            params.data_root, f"extracted_{NIN_VAL_SUBSETS[subset]}"
        )
    else:
        val_root = os.path.join(params.data_root, "extracted_val")
    val = NImageNet(val_root)
    if val_only:
        assert not gen_data
        return val
    if gen_data:
        return NImageNet(os.path.join(params.data_root, "extracted_train"))
    train = NImageNet(
        os.path.join(params.data_root, "extracted_train"),
        augmentation=True,
        num_shots=params.get("num_shots", None),
    )
    return train, val


def build_n_imagenet_mini_dataset(params, val_only=False, gen_data=False):
    val = NImageNetMini(os.path.join(params.data_root, "extracted_val"))
    if val_only:
        assert not gen_data
        return val
    if gen_data:
        return NImageNetMini(os.path.join(params.data_root, "extracted_train"))
    train = NImageNetMini(
        os.path.join(params.data_root, "extracted_train"),
        augmentation=True,
        num_shots=params.get("num_shots", None),
        repeat=params.get("repeat_data", True),
    )
    return train, val


_BUILD_FNS = {
    "n_caltech": build_n_caltech_dataset,
    "n_cars": build_n_cars_dataset,
    "n_imagenet": build_n_imagenet_dataset,
    "n_imagenet_mini": build_n_imagenet_mini_dataset,
}

# reader classes by config name; consumers that need the sensor stats
# without a dataset tree on disk (serve.Predictor) read their resolution /
# max_n
DATASET_CLASSES = {
    "n_caltech": NCaltech101,
    "n_cars": NCars,
    "n_imagenet": NImageNet,
    "n_imagenet_mini": NImageNetMini,
}


def build_dataset(params, val_only: bool = False, gen_data: bool = False,
                  tta: bool = False, **kwargs):
    """Reference datasets/__init__.py:11-32: build + wrap in the window
    pipeline; val view budget forced to 10."""
    from .event_windows import EventWindowDataset

    build_fn = _BUILD_FNS[params.dataset]
    ev = build_fn(params, val_only=val_only, gen_data=gen_data, **kwargs)

    q = dict(params.quantize_args)
    val_q = dict(q, max_imgs=10)  # load all views for testing

    if val_only or gen_data:
        return EventWindowDataset(ev, val_q, tta=tta)
    train, val = ev
    return (
        EventWindowDataset(
            train, q, augment=params.get("img_aug", False),
        ),
        EventWindowDataset(val, val_q),
    )
